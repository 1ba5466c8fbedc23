"""Parity-only detect (65,64): one check bit, no correction.

The single check bit folds the whole 64-bit word: any odd number of flipped
bits raises the (uncorrectable) detect flag, every even-weight fault aliases
silently. The low end of the coverage/overhead curve (1.6% redundancy
against SECDED's 12.5%).
"""

from __future__ import annotations

import numpy as np

from repro_torch.codes.base import Codec, build_luts, register


class ParityCodec(Codec):
    name = "parity65"
    kernel_id = 0
    n_check = 1
    corrects_random = 0
    detects_random = 1
    corrects_burst = 0
    sure_correct = 0

    def __init__(self):
        self.mask_lo = np.array([0xFFFFFFFF], dtype=np.uint32)
        self.mask_hi = np.array([0xFFFFFFFF], dtype=np.uint32)
        luts = build_luts(self.n_check, [])  # nothing is correctable
        self.lut_status = luts["lut_status"]
        self.lut_flip_lo = luts["lut_flip_lo"]
        self.lut_flip_hi = luts["lut_flip_hi"]
        self.lut_flip_check = luts["lut_flip_check"]

    def _classify_table_bytes(self) -> np.ndarray:
        """None: the kernels classify by the syndrome bit alone."""
        return np.zeros(0, np.uint8)


@register("parity65")
def _parity65() -> ParityCodec:
    return ParityCodec()
