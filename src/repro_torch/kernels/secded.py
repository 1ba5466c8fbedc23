"""Launch wrappers of the ECC encode and decode kernels (csrc/secded.cu), for
every codec; check planes are the codec's ``check_torch_dtype``."""

from __future__ import annotations

import torch

from repro_torch.codes import Codec
from repro_torch.kernels import backend as B

DECODE = B.Kernel("secded", "decode", [B.I32] + [B.VP] * 7 + [B.I64, B.VP], by_codec=True)
ENCODE = B.Kernel(
    "secded", "encode",
    [B.I32, B.VP, B.VP, B.I32, B.VP, B.I32, B.VP, B.VP, B.VP, B.VP, B.I64, B.VP],
    by_codec=True,
)


def encode(lo, hi, *, codec: Codec):
    """Flat planes -> check plane."""
    n = lo.numel()
    B.check(lo, torch.int32, "lo", (n,))
    B.check(hi, torch.int32, "hi", (n,))
    out = torch.empty(n, dtype=codec.check_torch_dtype, device=lo.device)
    if n:
        ENCODE(
            codec.kernel_id, B.ptr(lo), B.ptr(hi), 1, None, 0, None, None, B.ptr(out),
            B.ptr(codec.kernel_tables(lo.device)), n, B.stream(lo),
        )
    return out


def encode_commit(payload, row_base, row_words: int, lo, hi, check, *, codec: Codec):
    """Encode the rows of a float32 payload (R, 2 * row_words) and scatter
    them into flat planes: word j of row r (f32 values 2j, 2j + 1 as lo, hi)
    goes to index row_base[r] + j of lo, hi and check, in place. Destinations
    must be distinct where the caller needs a defined result."""
    r = payload.shape[0]
    B.check(payload, torch.float32, "payload", (r, 2 * row_words))
    B.check(row_base, torch.int64, "row_base", (r,))
    n = lo.numel()
    B.check(lo, torch.int32, "lo", (n,))
    B.check(hi, torch.int32, "hi", (n,))
    B.check(check, codec.check_torch_dtype, "check", (n,))
    if r and row_words:
        words = payload.view(torch.int32)
        ENCODE(
            codec.kernel_id, B.ptr(words), B.ptr(words[:, 1:]), 2, B.ptr(row_base), row_words,
            B.ptr(lo), B.ptr(hi), B.ptr(check), B.ptr(codec.kernel_tables(lo.device)),
            r * row_words, B.stream(lo),
        )


def decode_path(lo, hi, check) -> str:
    """The loop the decode kernel takes on these input planes: "quad" where
    lo and hi start on 16 bytes and the check plane on a quad of its words
    (its last n % 4 words then take the word loop), else "word". Its
    outputs are new allocations, aligned."""
    quad = 4 * check.element_size()
    ok = lo.data_ptr() % 16 == 0 and hi.data_ptr() % 16 == 0 and check.data_ptr() % quad == 0
    return "quad" if ok else "word"


def decode(lo, hi, check, *, codec: Codec):
    """Flat planes -> (corrected lo, corrected hi, status int32)."""
    n = lo.numel()
    B.check(lo, torch.int32, "lo", (n,))
    B.check(hi, torch.int32, "hi", (n,))
    B.check(check, codec.check_torch_dtype, "check", (n,))
    olo, ohi = torch.empty_like(lo), torch.empty_like(hi)
    status = torch.empty(n, dtype=torch.int32, device=lo.device)
    if n:
        DECODE(
            codec.kernel_id, B.ptr(lo), B.ptr(hi), B.ptr(check), B.ptr(olo), B.ptr(ohi), B.ptr(status),
            B.ptr(codec.kernel_tables(lo.device)), n, B.stream(lo),
        )
    return olo, ohi, status
