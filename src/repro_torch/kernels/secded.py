"""Launch wrapper of the SECDED decode kernel (csrc/secded.cu)."""

from __future__ import annotations

import torch

from repro_torch.codes import Codec
from repro_torch.kernels import backend as B

DECODE = B.Kernel("secded", "decode", [B.VP] * 7 + [B.I64, B.VP])


def decode(lo, hi, check, *, codec: Codec):
    """Flat planes -> (corrected lo, corrected hi, status int32)."""
    n = lo.numel()
    B.check(lo, torch.int32, "lo", (n,))
    B.check(hi, torch.int32, "hi", (n,))
    B.check(check, torch.uint8, "check", (n,))
    olo, ohi = torch.empty_like(lo), torch.empty_like(hi)
    status = torch.empty(n, dtype=torch.int32, device=lo.device)
    if n:
        DECODE(
            B.ptr(lo), B.ptr(hi), B.ptr(check), B.ptr(olo), B.ptr(ohi), B.ptr(status),
            B.ptr(codec.kernel_tables(lo.device)), n, B.stream(lo),
        )
    return olo, ohi, status
