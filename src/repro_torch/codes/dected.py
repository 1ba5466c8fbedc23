"""DEC-TED (79,64): double-error-correcting, triple-error-detecting BCH.

The binary primitive BCH(127, 113, d=5) over GF(2^7) (primitive polynomial
x^7 + x^3 + 1), extended with an overall parity row (d=6) and shortened to
64 data bits. Column ``i`` of the parity-check matrix is
[alpha^i | alpha^{3i} | 1] (15 rows), put in systematic form by Gaussian
elimination over GF(2). Every 1- and 2-bit pattern has its own non-zero
syndrome (3,160 correctable syndromes of 2**15, in the dense tables), and
every 3-bit pattern is detected. ``build_luts`` raises on any collision.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.codes.base import N_DATA, Codec, build_luts, register

N_CHECK = 15
N_POS = N_DATA + N_CHECK  # 79 codeword bits after shortening

_GF_POLY = 0x89  # x^7 + x^3 + 1, primitive over GF(2^7)
_GF_ORDER = 127


def _gf_powers() -> list:
    """alpha^0 .. alpha^126 as 7-bit field elements."""
    out, x = [], 1
    for _ in range(_GF_ORDER):
        out.append(x)
        x <<= 1
        if x & 0x80:
            x ^= 0x80 | (_GF_POLY & 0x7F)
    return out


def _gf2_inv(mat: np.ndarray) -> np.ndarray:
    """Inverse of a square GF(2) matrix (bool); raises if singular."""
    m = mat.shape[0]
    aug = np.concatenate([mat.copy(), np.eye(m, dtype=bool)], axis=1)
    for col in range(m):
        piv = next((r for r in range(col, m) if aug[r, col]), None)
        assert piv is not None, "check-position submatrix is singular"
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        for r in range(m):
            if r != col and aug[r, col]:
                aug[r] ^= aug[col]
    return aug[:, m:]


@functools.lru_cache(maxsize=None)
def build_dected() -> dict:
    """Systematic H, per-position syndromes and the dense correction tables."""
    alpha = _gf_powers()
    h = np.zeros((N_CHECK, N_POS), dtype=bool)
    for i in range(N_POS):
        col = alpha[i] | (alpha[(3 * i) % _GF_ORDER] << 7) | (1 << 14)
        for r in range(N_CHECK):
            h[r, i] = (col >> r) & 1
    t = _gf2_inv(h[:, N_DATA:])
    h_sys = (t.astype(np.uint8) @ h.astype(np.uint8)) % 2
    assert np.array_equal(h_sys[:, N_DATA:], np.eye(N_CHECK, dtype=np.uint8))

    mask_lo = np.zeros(N_CHECK, dtype=np.uint32)
    mask_hi = np.zeros(N_CHECK, dtype=np.uint32)
    for d in range(N_DATA):
        for r in range(N_CHECK):
            if h_sys[r, d]:
                if d < 32:
                    mask_lo[r] |= np.uint32(1 << d)
                else:
                    mask_hi[r] |= np.uint32(1 << (d - 32))

    synd = np.zeros(N_POS, dtype=np.int64)
    flips = np.zeros((N_POS, 3), dtype=np.uint32)  # (flip_lo, flip_hi, flip_check)
    for p in range(N_POS):
        if p < N_DATA:
            synd[p] = sum(int(h_sys[r, p]) << r for r in range(N_CHECK))
            flips[p, 0 if p < 32 else 1] = np.uint32(1 << (p % 32))
        else:
            synd[p] = 1 << (p - N_DATA)
            flips[p, 2] = np.uint32(1 << (p - N_DATA))

    patterns = [(int(synd[p]), *flips[p]) for p in range(N_POS)]
    for p in range(N_POS):
        for q in range(p + 1, N_POS):
            patterns.append((
                int(synd[p] ^ synd[q]),
                flips[p, 0] ^ flips[q, 0],
                flips[p, 1] ^ flips[q, 1],
                flips[p, 2] ^ flips[q, 2],
            ))
    luts = build_luts(N_CHECK, patterns)
    return {"mask_lo": mask_lo, "mask_hi": mask_hi, "position_syndromes": synd, **luts}


class DectedCodec(Codec):
    """Shortened extended BCH: corrects any 1-2 flips, detects any 3."""

    name = "dected79"
    kernel_id = 3
    n_check = N_CHECK
    corrects_random = 2
    detects_random = 3
    corrects_burst = 2
    sure_correct = 2

    def __init__(self):
        code = build_dected()
        self.mask_lo = code["mask_lo"]
        self.mask_hi = code["mask_hi"]
        self.lut_status = code["lut_status"]
        self.lut_flip_lo = code["lut_flip_lo"]
        self.lut_flip_hi = code["lut_flip_hi"]
        self.lut_flip_check = code["lut_flip_check"]


@register("dected79")
def _dected79() -> DectedCodec:
    return DectedCodec()
