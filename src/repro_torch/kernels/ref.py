"""Plain PyTorch versions of every kernel (the CPU path and the card's
yardstick). Word planes are int32 bit patterns, check planes the codec's
``check_torch_dtype`` (uint8, or int32 beyond 8 check bits)."""

from __future__ import annotations

import torch

from repro_torch import codes
from repro_torch.codes.base import WORD_MASK, check_dtypes, narrow, widen
from repro_torch.core import faultsim  # its fault field calls back into this module
from repro_torch.core.telemetry import counter_lanes

N_COUNTERS = 8
PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # Philox4x32 round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # Weyl increments of the round keys


def decode_ref(lo, hi, check, codec: str = codes.DEFAULT_CODEC):
    """-> (lo', hi', status int32)."""
    return codes.get(codec).decode(lo, hi, check)


def encode_ref(lo, hi, codec: str = codes.DEFAULT_CODEC):
    """Check plane of int32 word planes."""
    return codes.get(codec).encode(lo, hi)


def encode_commit_ref(payload, row_base, row_words: int, lo, hi, check,
                      codec: str = codes.DEFAULT_CODEC):
    """Encode float32 payload rows (R, 2 * row_words) and write word j of row
    r to index row_base[r] + j of the flat planes, in place."""
    words = payload.contiguous().view(torch.int32).reshape(-1, row_words, 2)
    rlo, rhi = words[..., 0], words[..., 1]
    idx = row_base.to(torch.int64)[:, None] + torch.arange(row_words, device=lo.device)
    lo[idx] = rlo
    hi[idx] = rhi
    check[idx] = encode_ref(rlo, rhi, codec)


def gather_scrub_ref(lo, hi, check, page_ids, words_per_page: int,
                     codec: str = codes.DEFAULT_CODEC):
    """Scrub-on-read of pages ``page_ids`` of the flat arena planes: gather
    every row, decode, re-encode the check bits except on detected words
    (their stored bits stay, so the DED flag stays latched; their data keeps
    the decoder's flips, as in the reference), write the rows
    back in place. Returns (payload (P, 2 * words_per_page) float32, lo and
    hi interleaved; counters (P, N_COUNTERS) int32, lanes 0..2 = clean,
    corrected, detected). Every row comes from the words as they were
    before the call, duplicate ids included."""
    c = codes.get(codec)
    idx = page_ids.to(torch.int64)[:, None] * words_per_page + torch.arange(
        words_per_page, device=lo.device
    )
    glo, ghi, gchk = lo[idx], hi[idx], check[idx]
    olo, ohi, status = c.decode(glo, ghi, gchk)
    detected = status == codes.STATUS_DETECTED
    ochk = torch.where(detected, gchk, c.encode(olo, ohi))
    cnt = torch.zeros(idx.shape[0], N_COUNTERS, dtype=torch.int32, device=lo.device)
    for lane, st in enumerate((codes.STATUS_CLEAN, codes.STATUS_CORRECTED, codes.STATUS_DETECTED)):
        cnt[:, lane] = (status == st).sum(dim=1).to(torch.int32)
    lo[idx], hi[idx], check[idx] = olo, ohi, ochk
    payload = torch.stack([olo, ohi], dim=-1).view(torch.float32)
    return payload.reshape(idx.shape[0], 2 * words_per_page), cnt


def inject_ref(lo, hi, check, mlo, mhi, mcheck):
    """XOR flip masks into the three planes -> (faulty lo, hi, check)."""
    return lo ^ mlo, hi ^ mhi, check ^ mcheck


def _inject_classify(lo, hi, check, mlo, mhi, mcheck, reencode, codec):
    """Faulty planes and the per-word counter lanes. Codecs with
    ``exact_tallies`` count a correction as genuine only when the decoder's
    data flips equal the injected data masks."""
    c = codes.get(codec)
    flo, fhi = narrow(widen(lo) ^ widen(mlo)), narrow(widen(hi) ^ widen(mhi))
    fchk = c.encode(flo, fhi) if reencode else check ^ mcheck
    flip_lo, flip_hi, status = c.classify(c.syndrome(flo, fhi, fchk))
    genuine = (
        (status == codes.STATUS_CORRECTED) & (flip_lo == widen(mlo)) & (flip_hi == widen(mhi))
        if c.exact_tallies else None
    )
    return flo, fhi, fchk, counter_lanes(status, faultsim.flip_counts(mlo, mhi, mcheck), genuine)


def inject_scrub_ref(lo, hi, check, mlo, mhi, mcheck, reencode=False,
                     codec: str = codes.DEFAULT_CODEC):
    """Inject -> (re-encode) -> decode -> counters: (faulty lo, hi, check,
    counters (8,) int32)."""
    flo, fhi, fchk, tallies = _inject_classify(lo, hi, check, mlo, mhi, mcheck, reencode, codec)
    counters = torch.stack([t.sum() for t in tallies])
    return flo, fhi, fchk, counters.to(torch.int32)


def inject_scrub_domains_ref(lo, hi, check, mlo, mhi, mcheck, dom, n_domains: int,
                             reencode=False, codec: str = codes.DEFAULT_CODEC):
    """As inject_scrub_ref with one counter row per domain index of ``dom``:
    counters (n_domains, 8) int32."""
    flo, fhi, fchk, tallies = _inject_classify(lo, hi, check, mlo, mhi, mcheck, reencode, codec)
    rows = []
    for d in range(n_domains):
        sel = dom == d
        rows.append(torch.stack([t[sel].sum() for t in tallies]))
    return flo, fhi, fchk, torch.stack(rows).to(torch.int32)


def pack_words(w_int8: torch.Tensor):
    """int8 (K, N), K % 8 == 0 -> (lo, hi) int32 (K/8, N) data planes.

    Codeword i of column n packs W[j*K/8 + i, n] for j = 0..7 (bytes 0-3 in
    lo, 4-7 in hi)."""
    k, n = w_int8.shape
    assert k % 8 == 0, k
    wr = w_int8.reshape(8, k // 8, n).to(torch.int64) & 0xFF
    lo = narrow(wr[0] | (wr[1] << 8) | (wr[2] << 16) | (wr[3] << 24))
    hi = narrow(wr[4] | (wr[5] << 8) | (wr[6] << 16) | (wr[7] << 24))
    return lo, hi


def unpack_ecc_weights(lo, hi) -> torch.Tensor:
    """Inverse packing: (K/8, N) planes -> (K, N) int8."""
    planes = [(widen(word) >> (8 * j)) & 0xFF for word in (lo, hi) for j in range(4)]
    w = torch.cat(planes, dim=0)  # rows j-major: row j*K8 + i
    return ((w ^ 128) - 128).to(torch.int8)


def ecc_matmul_ref(x, lo, hi, check, scale=None, codec: str = codes.DEFAULT_CODEC):
    """decode -> unpack -> dequant -> matmul for an (M, K) x in natural
    layout and (K/8, N) planes; float32 result."""
    lo2, hi2, _ = decode_ref(lo, hi, check, codec)
    w = unpack_ecc_weights(lo2, hi2).to(torch.float32)
    out = x.to(torch.float32) @ w
    if scale is not None:
        out = out * scale
    return out


def mulhilo32(a, m):
    """(hi, lo) 32-bit halves of the 64-bit product of ``a`` and ``m``,
    values in [0, 2**32) held in int64 (tensors or ints). A 32 x 32-bit
    product overflows a signed int64, so ``m`` is split into 16-bit halves:
    t = a * m_lo16 and u = a * m_hi16 + (t >> 16) stay below 2**49."""
    t = a * (m & 0xFFFF)
    u = a * (m >> 16) + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under the key (k0, k1):
    four int64 tensors (broadcast together) of values in [0, 2**32)."""
    for _ in range(10):
        hi0, lo0 = mulhilo32(c0, PHILOX_M[0])
        hi1, lo1 = mulhilo32(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W[0]) & WORD_MASK, (k1 + PHILOX_W[1]) & WORD_MASK
    return c0, c1, c2, c3


def fault_field_ref(f_row, rate, key: int, n_check: int, base: int = 0):
    """Flip masks of the words ``base .. base + n`` of a fault field (the
    fault-field kernel's arithmetic): ``f_row`` (n,) float32 row weakness,
    ``rate`` a float or an (n,) float32 tensor, ``key`` the field's 64-bit
    Philox key. Word w's bit b flips iff output b % 4 of Philox4x32-10 at
    counter (w low 32 bits, w high 32 bits, b // 4, 0) is below
    uint32(clip(rate f, 0, P_MAX) 2^32). Returns (lo int32, hi int32, check
    uint8 or int32) bit patterns."""
    dev, n = f_row.device, f_row.numel()
    rate = torch.as_tensor(rate, dtype=torch.float32, device=dev)
    thresh = (torch.clamp(rate * f_row, 0.0, faultsim.P_MAX) * 4294967296.0).to(torch.int64)
    w = torch.arange(base, base + n, dtype=torch.int64, device=dev)[None, :]
    groups = (64 + n_check + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=dev)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out = philox4x32_10(w & WORD_MASK, w >> 32, g, zero, key & WORD_MASK, key >> 32)
    bits = torch.stack(out, dim=1).reshape(4 * groups, n)[: 64 + n_check]
    shifts = torch.arange(32, dtype=torch.int64, device=dev)[:, None]
    pack = lambda rows: ((rows < thresh).to(torch.int64) << shifts[: rows.shape[0]]).sum(dim=0)
    return (narrow(pack(bits[:32])), narrow(pack(bits[32:64])),
            pack(bits[64:]).to(check_dtypes(n_check)[1]))
