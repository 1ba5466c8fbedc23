"""Launch wrappers of the fused inject+scrub kernels (csrc/inject_scrub.cu).

Planes are flat: lo/hi int32 (uint32 bit patterns), check uint8, masks
alike, domain ids int32. Outputs are allocated here; the kernels allocate
nothing and run on the current stream.
"""

from __future__ import annotations

import torch

from repro_torch.codes import Codec
from repro_torch.kernels import backend as B

N_COUNTERS = 8

INJECT_SCRUB = B.Kernel("inject_scrub", "inject_scrub", [B.VP] * 11 + [B.I64, B.I32, B.VP])
INJECT_SCRUB_DOMAINS = B.Kernel(
    "inject_scrub", "inject_scrub_domains", [B.VP] * 12 + [B.I64, B.I32, B.I32, B.VP]
)


def inject_scrub(lo, hi, check, mlo, mhi, mcheck, *, codec: Codec, reencode: bool):
    """-> (faulty lo, hi, check, counters (N_COUNTERS,) int32)."""
    n = B.check_planes(lo, hi, check, mlo, mhi, mcheck)
    olo, ohi, ochk = torch.empty_like(lo), torch.empty_like(hi), torch.empty_like(check)
    cnt = torch.zeros(N_COUNTERS, dtype=torch.int32, device=lo.device)
    if n:
        INJECT_SCRUB(
            B.ptr(lo), B.ptr(hi), B.ptr(check), B.ptr(mlo), B.ptr(mhi), B.ptr(mcheck),
            B.ptr(olo), B.ptr(ohi), B.ptr(ochk), B.ptr(cnt),
            B.ptr(codec.kernel_tables(lo.device)), n, int(reencode), B.stream(lo),
        )
    return olo, ohi, ochk, cnt


def inject_scrub_domains(
    lo, hi, check, mlo, mhi, mcheck, dom, n_domains: int, *, codec: Codec, reencode: bool
):
    """-> (faulty lo, hi, check, counters (n_domains, N_COUNTERS) int32);
    ``dom`` holds every word's domain index; a word whose index lies outside
    [0, n_domains) is counted in no row."""
    n = B.check_planes(lo, hi, check, mlo, mhi, mcheck)
    B.check(dom, torch.int32, "domain_ids", (n,))
    if not 1 <= n_domains <= 16:
        raise ValueError(f"n_domains must be in [1, 16], got {n_domains}")
    olo, ohi, ochk = torch.empty_like(lo), torch.empty_like(hi), torch.empty_like(check)
    cnt = torch.zeros(n_domains, N_COUNTERS, dtype=torch.int32, device=lo.device)
    if n:
        INJECT_SCRUB_DOMAINS(
            B.ptr(lo), B.ptr(hi), B.ptr(check), B.ptr(mlo), B.ptr(mhi), B.ptr(mcheck),
            B.ptr(dom), B.ptr(olo), B.ptr(ohi), B.ptr(ochk), B.ptr(cnt),
            B.ptr(codec.kernel_tables(lo.device)), n, int(reencode), n_domains,
            B.stream(lo),
        )
    return olo, ohi, ochk, cnt
