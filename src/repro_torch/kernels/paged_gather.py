"""Launch wrapper of the paged scrub-on-read kernel (csrc/paged_gather.cu)."""

from __future__ import annotations

import torch

from repro_torch.codes import Codec
from repro_torch.kernels import backend as B

N_COUNTERS = 8

GATHER_SCRUB = B.Kernel(
    "paged_gather", "gather_scrub", [B.VP] * 4 + [B.I32, B.I64] + [B.VP] * 5
)


def gather_scrub(lo, hi, check, page_ids, words_per_page: int, *, codec: Codec):
    """Scrub the pages ``page_ids`` (int32 on the planes' device) of the flat
    arena planes in place. Returns (payload (P, 2 * words_per_page) float32,
    counters (P, N_COUNTERS) int32, lanes 0..2 = clean, corrected,
    detected)."""
    n = lo.numel()
    B.check(lo, torch.int32, "lo", (n,))
    B.check(hi, torch.int32, "hi", (n,))
    B.check(check, torch.uint8, "check", (n,))
    p = page_ids.numel()
    B.check(page_ids, torch.int32, "page_ids", (p,))
    if words_per_page < 1 or n % words_per_page:
        raise ValueError(f"arena of {n} words is not a whole number of {words_per_page}-word pages")
    payload = torch.empty(p, words_per_page, 2, dtype=torch.int32, device=lo.device)
    stage = torch.empty(p, words_per_page, dtype=torch.uint8, device=lo.device)
    cnt = torch.zeros(p, N_COUNTERS, dtype=torch.int32, device=lo.device)
    if p:
        GATHER_SCRUB(
            B.ptr(lo), B.ptr(hi), B.ptr(check), B.ptr(page_ids), p, words_per_page,
            B.ptr(payload), B.ptr(stage), B.ptr(cnt), B.ptr(codec.kernel_tables(lo.device)),
            B.stream(lo),
        )
    return payload.view(torch.float32).reshape(p, 2 * words_per_page), cnt
