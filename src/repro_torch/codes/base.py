"""ECC codec abstraction + registry over 64-bit data words.

Word representation: the lo/hi data planes are ``torch.int32`` tensors that
hold the uint32 bit pattern (numpy ``uint32`` converts with
``.view(np.int32)``, zero-copy and exact). Torch on the CPU implements no
shifts for ``torch.uint32`` and shifts ``int32`` arithmetically, so the plain
functions here widen to int64 (``widen``) before shifting and narrow back
with ``narrow``. Check planes are ``torch.uint8`` up to 8 check bits and
``torch.int32`` holding the uint32 bit pattern beyond (every value is below
2**24, so the sign never matters; ``np.uint32`` converts with
``.view(np.int32)``).

A ``Codec`` carries the systematic parity-check matrix as encode masks (check
bit ``r`` is the XOR-fold of ``lo & mask_lo[r]`` and ``hi & mask_hi[r]``) and
a syndrome classification: status (clean / corrected / detected) and the
data flips of the correction, from a dense syndrome table where the codec
has one (``classify`` is overridden where it has not). The CUDA kernels read
the codec's table layout of ``kernels/csrc/codec.cuh`` (``kernel_tables``).
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


def check_dtypes(n_check: int):
    """(numpy, torch) dtypes of a check plane of ``n_check`` bits: uint8 up
    to 8 bits, else uint32, carried in torch as int32 bit patterns."""
    return (np.uint8, torch.uint8) if n_check <= 8 else (np.uint32, torch.int32)


def as_words(a: np.ndarray) -> np.ndarray:
    """A uint32 plane viewed as int32 (the bit patterns torch carries); any
    other plane as it is."""
    return a.view(np.int32) if a.dtype == np.uint32 else a


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
    """One registered ECC scheme over 64-bit data words."""

    name: str
    kernel_id: int  # the codec's id in kernels/csrc/codec.cuh
    n_check: int
    corrects_random: int
    detects_random: int
    corrects_burst: int
    sure_correct: int
    mask_lo: np.ndarray  # (n_check,) uint32
    mask_hi: np.ndarray  # (n_check,) uint32
    # dense syndrome tables of length 2**n_check; None where the syndrome
    # space is too large (the codec then overrides ``classify``)
    lut_status: np.ndarray | None  # int32
    lut_flip_lo: np.ndarray | None  # uint32
    lut_flip_hi: np.ndarray | None
    lut_flip_check: np.ndarray | None

    @property
    def check_dtype(self):
        """numpy storage dtype of the check plane (uint8 up to 8 check bits,
        uint32 beyond)."""
        return check_dtypes(self.n_check)[0]

    @property
    def check_torch_dtype(self) -> torch.dtype:
        """torch dtype of the check plane: uint8, or int32 holding the uint32
        bit pattern."""
        return check_dtypes(self.n_check)[1]

    @property
    def exact_tallies(self) -> bool:
        """Whether the counters compare the correction with the injected data
        mask to count genuine corrections (codecs that correct more than one
        random bit or a burst), instead of the single-flip formula that is
        exact for SEC codes."""
        return self.corrects_random > 1 or self.corrects_burst > 1

    @functools.lru_cache(maxsize=None)
    def tables(self, device: torch.device) -> dict:
        """The masks as ints, and the dense syndrome tables (where the codec
        has them) as int64 tensors on ``device``."""
        out = {
            "mask_lo": [int(m) for m in self.mask_lo],
            "mask_hi": [int(m) for m in self.mask_hi],
        }
        if self.lut_status is not None:
            as_t = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
            out.update(status=as_t(self.lut_status), flip_lo=as_t(self.lut_flip_lo),
                       flip_hi=as_t(self.lut_flip_hi))
        return out

    def _classify_table_bytes(self) -> np.ndarray:
        """Dense form: flip_lo[2**n], flip_hi[2**n] (uint32), status[2**n]
        (uint8)."""
        flips = np.concatenate([self.lut_flip_lo, self.lut_flip_hi]).astype(np.uint32)
        return np.concatenate([flips.view(np.uint8), self.lut_status.astype(np.uint8)])

    @functools.lru_cache(maxsize=None)
    def kernel_tables(self, device: torch.device) -> torch.Tensor:
        """The codec's table struct of kernels/csrc/codec.cuh as bytes on
        ``device``: mask_lo[n_check] and mask_hi[n_check] (uint32), then the
        codec's classification tables (``_classify_table_bytes``)."""
        words = np.concatenate([self.mask_lo, self.mask_hi]).astype(np.uint32)
        raw = np.concatenate([words.view(np.uint8), self._classify_table_bytes()])
        return torch.from_numpy(raw).to(device)

    # ---------------------------------------------------------- plain torch
    def encode(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """Check plane (``check_torch_dtype``) of int32 word planes."""
        lo, hi = widen(lo), widen(hi)
        c = torch.zeros_like(lo)
        t = self.tables(lo.device)
        for r in range(self.n_check):
            c |= parity32((lo & t["mask_lo"][r]) ^ (hi & t["mask_hi"][r])) << r
        return c.to(self.check_torch_dtype)

    def syndrome(self, lo, hi, check) -> torch.Tensor:
        """int64 syndrome in [0, 2**n_check)."""
        return self.encode(lo, hi).to(torch.int64) ^ check.to(torch.int64)

    def classify(self, synd: torch.Tensor):
        """Syndrome -> (flip_lo, flip_hi) widened int64, status int32 (dense
        table gather). The flips apply whatever the status, as in the
        reference's decode."""
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
