"""4-way bit-interleaved SECDED (88,64): a burst of up to 4 adjacent flips
lands one flip in each subcode.

Four Hsiao(22,16) SECDED subcodes protect the word with the bit lanes
interleaved: data bit ``j`` belongs to subcode ``j % 4`` (sub-bit ``j // 4``)
and check bit ``b`` to subcode ``b % 4`` (sub-check ``b // 4``). Two random
flips are corrected when they land in different subcodes and detected
otherwise.

The syndrome factors into four 6-bit sub-syndromes, each classified against
the subcode's 64-entry action table (``build_hsiao(16, 6)["syndrome_lut"]``:
-1 clean, -2 detected, 0..15 a data bit, 16..21 a check bit). The dense 2**24
table is never built (``lut_status is None``). A subcode's correction is
applied even when another subcode detects, as in the reference decode.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.codes import base
from repro_torch.codes.base import Codec, register
from repro_torch.codes.secded import build_hsiao

N_WAYS = 4
SUB_DATA = 16
SUB_CHECK = 6
N_CHECK = N_WAYS * SUB_CHECK  # 24


def _sub_positions(s: int) -> np.ndarray:
    """Global data-bit indices owned by subcode ``s`` (sub-bit order)."""
    return np.arange(SUB_DATA) * N_WAYS + s


@functools.lru_cache(maxsize=None)
def build_interleaved() -> dict:
    sub = build_hsiao(SUB_DATA, SUB_CHECK)
    mask_lo = np.zeros(N_CHECK, dtype=np.uint32)
    mask_hi = np.zeros(N_CHECK, dtype=np.uint32)
    for b in range(N_CHECK):
        s, r = b % N_WAYS, b // N_WAYS
        for d, j in enumerate(_sub_positions(s)):
            if (int(sub["data_cols"][d]) >> r) & 1:
                if j < 32:
                    mask_lo[b] |= np.uint32(1 << j)
                else:
                    mask_hi[b] |= np.uint32(1 << (j - 32))
    return {"sub": sub, "mask_lo": mask_lo, "mask_hi": mask_hi}


class InterleavedCodec(Codec):
    name = "ileave88"
    kernel_id = 2
    n_check = N_CHECK
    corrects_random = 1
    detects_random = 2
    corrects_burst = N_WAYS
    sure_correct = 2

    def __init__(self):
        code = build_interleaved()
        self.mask_lo = code["mask_lo"]
        self.mask_hi = code["mask_hi"]
        self.sub_lut = code["sub"]["syndrome_lut"]  # (64,) int32 sub-syndrome actions
        self.lut_status = None
        self.lut_flip_lo = None
        self.lut_flip_hi = None
        self.lut_flip_check = None

    def _classify_table_bytes(self) -> np.ndarray:
        """sub_action[64] (int8)."""
        return self.sub_lut.astype(np.int8).view(np.uint8)

    @functools.lru_cache(maxsize=None)
    def _sub_lut(self, device: torch.device) -> torch.Tensor:
        return torch.as_tensor(self.sub_lut.astype(np.int64), device=device)

    def classify(self, synd: torch.Tensor):
        """Four sub-syndrome lookups -> (flip_lo, flip_hi) int64, status
        int32: detected if any subcode detects, else corrected if any
        corrects."""
        lut = self._sub_lut(synd.device)
        flip_lo = torch.zeros_like(synd)
        flip_hi = torch.zeros_like(synd)
        detect = torch.zeros(synd.shape, dtype=torch.bool, device=synd.device)
        correct = torch.zeros_like(detect)
        for s in range(N_WAYS):
            sub = torch.zeros_like(synd)
            for r in range(SUB_CHECK):
                sub |= ((synd >> (N_WAYS * r + s)) & 1) << r
            action = lut[sub]
            detect |= action == -2  # secded.LUT_DETECT
            correct |= action >= 0
            data = (action >= 0) & (action < SUB_DATA)
            j = action.clamp(0, SUB_DATA - 1) * N_WAYS + s
            bit = torch.where(data, torch.ones_like(j) << (j % 32), torch.zeros_like(j))
            flip_lo |= torch.where(j < 32, bit, 0)
            flip_hi |= torch.where(j >= 32, bit, 0)
        status = torch.where(
            detect, base.STATUS_DETECTED,
            torch.where(correct, base.STATUS_CORRECTED, base.STATUS_CLEAN),
        )
        return flip_lo, flip_hi, status.to(torch.int32)


@register("ileave88")
def _ileave88() -> InterleavedCodec:
    return InterleavedCodec()
