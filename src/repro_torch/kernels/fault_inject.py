"""Launch wrapper of the read-time fault-injection kernel
(csrc/fault_inject.cu)."""

from __future__ import annotations

import torch

from repro_torch.kernels import backend as B

INJECT = B.Kernel("fault_inject", "inject", [B.VP] * 9 + [B.I64, B.VP])


def inject(lo, hi, check, mlo, mhi, mcheck):
    """Flat planes and masks -> (lo ^ mlo, hi ^ mhi, check ^ mcheck) in new
    tensors."""
    n = B.check_planes(lo, hi, check, mlo, mhi, mcheck)
    olo, ohi, ochk = torch.empty_like(lo), torch.empty_like(hi), torch.empty_like(check)
    if n:
        INJECT(
            B.ptr(lo), B.ptr(hi), B.ptr(check), B.ptr(mlo), B.ptr(mhi), B.ptr(mcheck),
            B.ptr(olo), B.ptr(ohi), B.ptr(ochk), n, B.stream(lo),
        )
    return olo, ohi, ochk
