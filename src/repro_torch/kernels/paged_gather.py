"""Launch wrapper of the paged scrub-on-read kernel (csrc/paged_gather.cu)."""

from __future__ import annotations

import torch

from repro_torch.codes import Codec
from repro_torch.kernels import backend as B

N_COUNTERS = 8
CHUNK_WORDS = 128  # a chunk: 32 quads of four words, aligned to four in the arena
# per chunk: 4 data-changed and 4 check-changed ballots, one write-back list entry
RECORD_WORDS_PER_CHUNK = 9

GATHER_SCRUB = B.Kernel(
    "paged_gather", "gather_scrub",
    [B.I32] + [B.VP] * 4 + [B.I32, B.I64, B.VP, B.VP, B.I64] + [B.VP] * 4,
    by_codec=True,
)


def chunks_per_row(words_per_page: int) -> int:
    """Chunks of one table row: a page of W words starts up to three words
    into its first quad (its base ``id * W`` need not be a multiple of
    four), so it spans at most ``(W + 6) // 4`` quads."""
    quads = (words_per_page + 6) // 4
    return -(-quads // (CHUNK_WORDS // 4))


def record_words(n_rows: int, words_per_page: int) -> int:
    """int32 words of the changed-word record the kernel needs for a table
    of ``n_rows`` rows: one bit per word and plane kind and one list entry
    per chunk, so it holds every word of every row even when every word
    changes."""
    return n_rows * chunks_per_row(words_per_page) * RECORD_WORDS_PER_CHUNK


def gather_scrub(lo, hi, check, page_ids, words_per_page: int, *, codec: Codec):
    """Scrub the pages ``page_ids`` (int32 on the planes' device) of the flat
    arena planes in place. Returns (payload (P, 2 * words_per_page) float32,
    counters (P, N_COUNTERS) int32, lanes 0..2 = clean, corrected,
    detected)."""
    n = lo.numel()
    B.check(lo, torch.int32, "lo", (n,))
    B.check(hi, torch.int32, "hi", (n,))
    B.check(check, codec.check_torch_dtype, "check", (n,))
    p = page_ids.numel()
    B.check(page_ids, torch.int32, "page_ids", (p,))
    if words_per_page < 1 or n % words_per_page:
        raise ValueError(f"arena of {n} words is not a whole number of {words_per_page}-word pages")
    payload = torch.empty(p, words_per_page, 2, dtype=torch.int32, device=lo.device)
    # one row more: the kernel's count of the chunks it writes back later
    cnt = torch.zeros(p + 1, N_COUNTERS, dtype=torch.int32, device=lo.device)
    if p:
        rec = record_words(p, words_per_page)
        record = torch.empty(rec, dtype=torch.int32, device=lo.device)
        GATHER_SCRUB(
            codec.kernel_id, B.ptr(lo), B.ptr(hi), B.ptr(check), B.ptr(page_ids), p, words_per_page,
            B.ptr(payload), B.ptr(record), rec, B.ptr(cnt),
            B.ptr(codec.kernel_tables(lo.device)), B.ptr(codec.kernel_tables(torch.device("cpu"))),
            B.stream(lo),
        )
    return payload.view(torch.float32).reshape(p, 2 * words_per_page), cnt[:p]
