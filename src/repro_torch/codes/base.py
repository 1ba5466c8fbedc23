"""ECC codec abstraction + registry over 64-bit data words.

Word representation: the lo/hi data planes are ``torch.int32`` tensors that
hold the uint32 bit pattern (numpy ``uint32`` converts with
``.view(np.int32)``, zero-copy and exact). Torch on the CPU implements no
shifts for ``torch.uint32`` and shifts ``int32`` arithmetically, so the plain
functions here widen to int64 (``widen``) before shifting and narrow back
with ``narrow``. Check planes are ``torch.uint8``.

A ``Codec`` carries the systematic parity-check matrix as encode masks (check
bit ``r`` is the XOR-fold of ``lo & mask_lo[r]`` and ``hi & mask_hi[r]``) and
a dense syndrome table: status (clean / corrected / detected) and the data
flips of the correction. The CUDA kernels read the same table from shared
memory (``kernel_tables``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_DATA = 64

# The paper's built-in BRAM SECDED; every domain defaults to it.
DEFAULT_CODEC = "secded72"

STATUS_CLEAN = 0
STATUS_CORRECTED = 1
STATUS_DETECTED = 2

WORD_MASK = 0xFFFFFFFF


def widen(words: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 in [0, 2**32): logical shifts become safe."""
    return words.to(torch.int64) & WORD_MASK


def narrow(v: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> the int32 tensor holding the same bit pattern."""
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


def parity32(v: torch.Tensor) -> torch.Tensor:
    """XOR-fold of each widened word -> {0, 1} int64."""
    v = v ^ (v >> 16)
    v = v ^ (v >> 8)
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    return v & 1


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of widened words (int64 in, int64 out)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


class Codec:
    """One registered ECC scheme over 64-bit data words (<= 8 check bits)."""

    name: str
    n_check: int
    corrects_random: int
    detects_random: int
    corrects_burst: int
    sure_correct: int
    mask_lo: np.ndarray  # (n_check,) uint32
    mask_hi: np.ndarray  # (n_check,) uint32
    lut_status: np.ndarray  # (2**n_check,) int32
    lut_flip_lo: np.ndarray  # (2**n_check,) uint32
    lut_flip_hi: np.ndarray
    lut_flip_check: np.ndarray

    @functools.lru_cache(maxsize=None)
    def tables(self, device: torch.device) -> dict:
        """The mask and syndrome tables as int64 tensors on ``device``."""
        as_t = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
        return {
            "mask_lo": [int(m) for m in self.mask_lo],
            "mask_hi": [int(m) for m in self.mask_hi],
            "status": as_t(self.lut_status),
            "flip_lo": as_t(self.lut_flip_lo),
            "flip_hi": as_t(self.lut_flip_hi),
        }

    @functools.lru_cache(maxsize=None)
    def kernel_tables(self, device: torch.device) -> torch.Tensor:
        """The ``SecdedTables`` struct of kernels/csrc/secded.cuh as bytes on
        ``device``: mask_lo[8], mask_hi[8], flip_lo[256], flip_hi[256]
        (uint32), then status[256] (uint8)."""
        assert self.n_check == 8, self.name
        words = np.concatenate(
            [self.mask_lo, self.mask_hi, self.lut_flip_lo, self.lut_flip_hi]
        ).astype(np.uint32)
        raw = np.concatenate(
            [words.view(np.uint8), self.lut_status.astype(np.uint8)]
        )
        return torch.from_numpy(raw).to(device)

    # ---------------------------------------------------------- plain torch
    def encode(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """Check plane (uint8) of int32 word planes."""
        lo, hi = widen(lo), widen(hi)
        c = torch.zeros_like(lo)
        t = self.tables(lo.device)
        for r in range(self.n_check):
            c |= parity32((lo & t["mask_lo"][r]) ^ (hi & t["mask_hi"][r])) << r
        return c.to(torch.uint8)

    def syndrome(self, lo, hi, check) -> torch.Tensor:
        """int64 syndrome in [0, 2**n_check)."""
        return self.encode(lo, hi).to(torch.int64) ^ check.to(torch.int64)

    def classify(self, synd: torch.Tensor):
        """Syndrome -> (flip_lo, flip_hi) widened int64, status int32."""
        t = self.tables(synd.device)
        return t["flip_lo"][synd], t["flip_hi"][synd], t["status"][synd].to(torch.int32)

    def decode(self, lo, hi, check):
        """(lo', hi', status int32) with correctable errors fixed."""
        flip_lo, flip_hi, status = self.classify(self.syndrome(lo, hi, check))
        return narrow(widen(lo) ^ flip_lo), narrow(widen(hi) ^ flip_hi), status


def build_luts(n_check: int, patterns) -> dict:
    """Dense syndrome tables from (syndrome, flip_lo, flip_hi, flip_check)
    correctable patterns. Asserts every correctable syndrome is distinct."""
    size = 1 << n_check
    status = np.full(size, STATUS_DETECTED, np.int32)
    flip_lo = np.zeros(size, np.uint32)
    flip_hi = np.zeros(size, np.uint32)
    flip_check = np.zeros(size, np.uint32)
    status[0] = STATUS_CLEAN
    for synd, flo, fhi, fch in patterns:
        assert synd != 0, "correctable pattern aliases to the zero syndrome"
        assert status[synd] == STATUS_DETECTED, f"syndrome collision at {synd:#x}"
        status[synd] = STATUS_CORRECTED
        flip_lo[synd] = flo
        flip_hi[synd] = fhi
        flip_check[synd] = fch
    return {
        "lut_status": status,
        "lut_flip_lo": flip_lo,
        "lut_flip_hi": flip_hi,
        "lut_flip_check": flip_check,
    }


_FACTORIES: dict = {}


def register(name: str):
    """Decorator: register a zero-arg codec factory under ``name``."""

    def deco(factory):
        _FACTORIES[name] = functools.lru_cache(maxsize=None)(factory)
        return factory

    return deco


def get(name: str) -> Codec:
    try:
        return _FACTORIES[name]()
    except KeyError:
        raise KeyError(
            f"unknown codec {name!r}; registered: {sorted(_FACTORIES)}"
        ) from None


def names() -> tuple:
    return tuple(_FACTORIES)
