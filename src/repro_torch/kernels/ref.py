"""Plain PyTorch versions of every kernel (the CPU path and the card's
yardstick). Word planes are int32 bit patterns, check planes the codec's
``check_torch_dtype`` (uint8, or int32 beyond 8 check bits)."""

from __future__ import annotations

import math

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


NO_BURST = (0, 0, 0, 0)
ALWAYS = 1 << 32  # a burst threshold that every uint32 draw is below


def burst_thresholds(burst) -> tuple:
    """The fault-field kernel's burst thresholds (t3, t2, trd, twa) of a
    ``scenario.BurstProfile``: floor(p 2^32) of its cumulative class
    thresholds (triple, + double, + random double) and of ``word_adjacent``,
    each in [0, 2^32] (2^32: always). ``None`` is ``NO_BURST``."""
    if burst is None:
        return NO_BURST
    ps = (*burst.class_thresholds(), burst.word_adjacent)
    return tuple(min(int(math.floor(p * 4294967296.0)), ALWAYS) for p in ps)


def _philox_at(w, g, lane: int, key: int):
    """Philox4x32-10 at counters (w low, w high, g, lane) for 1-D int64 word
    indices ``w`` and groups ``g`` -> (K, 4) int64 outputs."""
    zero = torch.zeros((), dtype=torch.int64, device=w.device)
    out = philox4x32_10(w & WORD_MASK, w >> 32, g, zero + lane, key & WORD_MASK, key >> 32)
    return torch.stack(out, dim=-1)


def _lazy_draws(anchors, w, lane: int, key: int, groups: int):
    """The (nb, n) draws at Philox counter lane ``lane`` of the planes of
    every group that holds an anchor (ALWAYS elsewhere): the kernel draws
    these groups only, and the stream is fixed by position."""
    nb, n = anchors.shape
    held = torch.nn.functional.pad(anchors, (0, 0, 0, 4 * groups - nb))
    held = held.reshape(groups, 4, n).any(dim=1)
    gi, wi = torch.nonzero(held, as_tuple=True)
    out = torch.full((groups, 4, n), ALWAYS, dtype=torch.int64, device=anchors.device)
    out[gi, :, wi] = _philox_at(w[wi], gi, lane, key)
    return out.reshape(4 * groups, n)[:nb]


def _shift_up(bits, k: int):
    """(nb, n) planes moved ``k`` planes up, cut at the top plane."""
    return torch.cat([torch.zeros_like(bits[:k]), bits[:-k]])


def fault_field_ref(f_row, rate, key: int, n_check: int, base: int = 0, burst=NO_BURST,
                    lead: int = 0):
    """Flip masks of the words ``base + lead .. base + n`` of a fault field
    (the fault-field kernel's arithmetic): ``f_row`` (n,) float32 row
    weakness of the words ``base .. base + n``, ``rate`` a float or an (n,)
    float32 tensor, ``key`` the field's 64-bit Philox key, ``burst`` the
    kernel's burst thresholds (``burst_thresholds``). Word w's bit b is an
    anchor iff output b % 4 of Philox4x32-10 at counter (w low 32 bits, w
    high 32 bits, b // 4, 0) is below uint32(clip(rate f, 0, P_MAX) 2^32);
    without a burst the anchors are the flips. With one they expand as
    csrc/fault_field.cu describes; the first ``lead`` words (0 or 1) are
    drawn only for their word-adjacent spill into word ``base + lead`` and
    are not returned. A field's word 0 gets no spill. Returns (lo int32, hi
    int32, check uint8 or int32) bit patterns."""
    dev, n = f_row.device, f_row.numel()
    rate = torch.as_tensor(rate, dtype=torch.float32, device=dev)
    thresh = (torch.clamp(rate * f_row, 0.0, faultsim.P_MAX) * 4294967296.0).to(torch.int64)
    w = torch.arange(base, base + n, dtype=torch.int64, device=dev)
    nb, groups = 64 + n_check, (64 + n_check + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=dev)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out = philox4x32_10(w[None, :] & WORD_MASK, w[None, :] >> 32, g, zero, key & WORD_MASK,
                        key >> 32)
    bits = torch.stack(out, dim=1).reshape(4 * groups, n)[:nb] < thresh
    t3, t2, trd, twa = burst
    if trd or twa:
        anchors, bits = bits, bits.clone()
        if trd:
            cls = _lazy_draws(anchors, w, 1, key, groups)
            bits |= _shift_up(anchors & (cls < t2), 1) | _shift_up(anchors & (cls < t3), 2)
            rd = (anchors & (cls >= t2) & (cls < trd)).any(dim=0)
            if rd.any():
                x = _philox_at(w[rd], zero, 3, key)[:, 0]
                bits[(x * nb) >> 32, torch.nonzero(rd)[:, 0]] = True
        if twa:
            col = anchors & (_lazy_draws(anchors, w, 2, key, groups) < twa)
            bits[:, 1:] |= col[:, :-1]
    bits = bits[:, lead:].to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)[:, None]
    pack = lambda rows: (rows << shifts[: rows.shape[0]]).sum(dim=0)
    return (narrow(pack(bits[:32])), narrow(pack(bits[32:64])),
            pack(bits[64:]).to(check_dtypes(n_check)[1]))


def fault_field_plain(f_row, rate, key: int, n_check: int, burst=NO_BURST, *,
                      chunk_words: int):
    """``fault_field_ref`` over a whole field, ``chunk_words`` words a call
    (its int64 transients): a chunk after the first also draws the word
    before it when the burst spills across words, so the masks do not
    depend on the chunking."""
    per_word = isinstance(rate, torch.Tensor)
    n = f_row.numel()
    parts = []
    for s in range(0, n, chunk_words):
        a = s - 1 if s and burst[3] else s
        parts.append(fault_field_ref(f_row[a:s + chunk_words],
                                     rate[a:s + chunk_words] if per_word else rate,
                                     key, n_check, base=a, burst=burst, lead=s - a))
    if not parts:
        parts = [fault_field_ref(f_row, 0.0, key, n_check)]
    return tuple(torch.cat(ts) for ts in zip(*parts))
