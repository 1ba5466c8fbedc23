"""Plain PyTorch versions of every kernel (the CPU path and the card's
yardstick). Word planes are int32 bit patterns, check planes uint8."""

from __future__ import annotations

import torch

from repro_torch import codes
from repro_torch.codes.base import narrow, widen
from repro_torch.core.faultsim import flip_counts
from repro_torch.core.telemetry import counter_lanes

N_COUNTERS = 8


def decode_ref(lo, hi, check, codec: str = codes.DEFAULT_CODEC):
    """-> (lo', hi', status int32)."""
    return codes.get(codec).decode(lo, hi, check)


def encode_ref(lo, hi, codec: str = codes.DEFAULT_CODEC):
    """Check plane (uint8) of int32 word planes."""
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
    (their stored bits stay, so the DED flag stays latched), write the rows
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
    c = codes.get(codec)
    flo, fhi = narrow(widen(lo) ^ widen(mlo)), narrow(widen(hi) ^ widen(mhi))
    fchk = c.encode(flo, fhi) if reencode else check ^ mcheck
    status = c.decode(flo, fhi, fchk)[2]
    return flo, fhi, fchk, status, flip_counts(mlo, mhi, mcheck)


def inject_scrub_ref(lo, hi, check, mlo, mhi, mcheck, reencode=False,
                     codec: str = codes.DEFAULT_CODEC):
    """Inject -> (re-encode) -> decode -> counters: (faulty lo, hi, check,
    counters (8,) int32)."""
    flo, fhi, fchk, status, flips = _inject_classify(
        lo, hi, check, mlo, mhi, mcheck, reencode, codec
    )
    counters = torch.stack([t.sum() for t in counter_lanes(status, flips)])
    return flo, fhi, fchk, counters.to(torch.int32)


def inject_scrub_domains_ref(lo, hi, check, mlo, mhi, mcheck, dom, n_domains: int,
                             reencode=False, codec: str = codes.DEFAULT_CODEC):
    """As inject_scrub_ref with one counter row per domain index of ``dom``:
    counters (n_domains, 8) int32."""
    flo, fhi, fchk, status, flips = _inject_classify(
        lo, hi, check, mlo, mhi, mcheck, reencode, codec
    )
    tallies = counter_lanes(status, flips)
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
