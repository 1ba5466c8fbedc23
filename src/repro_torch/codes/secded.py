"""Hsiao odd-weight-column SECDED(72,64): the Xilinx 7-series BRAM ECC.

Every column of the 8 x 72 parity-check matrix is distinct and odd-weight;
the check positions take the weight-1 identity columns, the data positions
all weight-3 columns first, then greedily the higher-weight columns that keep
row weights balanced. Syndrome 0 is clean, a data or check column is a
correctable single flip, anything else (every double flip) is detected.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.codes.base import N_DATA, Codec, build_luts, register

N_PARITY = 8
N_BITS = N_DATA + N_PARITY

# Sentinels of the historical syndrome action table.
LUT_CLEAN = -1
LUT_DETECT = -2


def _popcount(x: int) -> int:
    return bin(x).count("1")


@functools.lru_cache(maxsize=None)
def build_hsiao(n_data: int, n_check: int) -> dict:
    """Deterministic Hsiao construction for an (n_data + n_check, n_data)
    SECDED code: data/parity columns, encode masks over the lo/hi halves of
    the data word, the historical action LUT and the row weights."""
    chosen: list[int] = []
    row_weight = np.zeros(n_check, dtype=np.int64)

    def add(c: int) -> None:
        chosen.append(c)
        for r in range(n_check):
            row_weight[r] += (c >> r) & 1

    for w in range(3, n_check + 1, 2):
        cands = [c for c in range(1 << n_check) if _popcount(c) == w]
        need = n_data - len(chosen)
        if need == 0:
            break
        if len(cands) <= need:
            for c in cands:
                add(c)
            continue
        for _ in range(need):
            best, best_key = None, None
            for c in cands:
                if c in chosen:
                    continue
                trial = row_weight.copy()
                for r in range(n_check):
                    trial[r] += (c >> r) & 1
                key = (int(trial.max()), int(trial.var() * 1e6), c)
                if best_key is None or key < best_key:
                    best, best_key = c, key
            add(best)
    assert len(chosen) == n_data, (
        f"not enough odd-weight {n_check}-bit columns for {n_data} data bits"
    )

    col_dtype = np.uint8 if n_check <= 8 else np.uint32
    data_cols = np.array(chosen, dtype=col_dtype)
    parity_cols = np.array([1 << r for r in range(n_check)], dtype=col_dtype)
    assert len(set(chosen) | set(int(c) for c in parity_cols)) == n_data + n_check

    mask_lo = np.zeros(n_check, dtype=np.uint32)
    mask_hi = np.zeros(n_check, dtype=np.uint32)
    for d in range(n_data):
        col = int(data_cols[d])
        for r in range(n_check):
            if (col >> r) & 1:
                if d < 32:
                    mask_lo[r] |= np.uint32(1 << d)
                else:
                    mask_hi[r] |= np.uint32(1 << (d - 32))

    lut = np.full(1 << n_check, LUT_DETECT, dtype=np.int32)
    lut[0] = LUT_CLEAN
    for d in range(n_data):
        lut[int(data_cols[d])] = d
    for r in range(n_check):
        lut[1 << r] = n_data + r

    return {
        "data_cols": data_cols,
        "parity_cols": parity_cols,
        "mask_lo": mask_lo,
        "mask_hi": mask_hi,
        "syndrome_lut": lut,
        "row_weight": row_weight,
    }


def build_code() -> dict:
    """The Hsiao(72,64) tables."""
    return build_hsiao(N_DATA, N_PARITY)


class SecdedCodec(Codec):
    """Hsiao SECDED(72,64): corrects any single, detects any double."""

    name = "secded72"
    kernel_id = 1
    n_check = N_PARITY
    corrects_random = 1
    detects_random = 2
    corrects_burst = 1
    sure_correct = 1

    def __init__(self):
        code = build_code()
        self.mask_lo = code["mask_lo"]
        self.mask_hi = code["mask_hi"]
        self.data_cols = code["data_cols"]
        patterns = []
        for d in range(N_DATA):
            flo = np.uint32(1 << d) if d < 32 else np.uint32(0)
            fhi = np.uint32(1 << (d - 32)) if d >= 32 else np.uint32(0)
            patterns.append((int(code["data_cols"][d]), flo, fhi, np.uint32(0)))
        for r in range(self.n_check):
            patterns.append((1 << r, np.uint32(0), np.uint32(0), np.uint32(1 << r)))
        luts = build_luts(self.n_check, patterns)
        self.lut_status = luts["lut_status"]
        self.lut_flip_lo = luts["lut_flip_lo"]
        self.lut_flip_hi = luts["lut_flip_hi"]
        self.lut_flip_check = luts["lut_flip_check"]


@register("secded72")
def _secded72() -> SecdedCodec:
    return SecdedCodec()
