"""Launch wrapper of the fault-field mask kernel (csrc/fault_field.cu)."""

from __future__ import annotations

import torch

from repro_torch.codes.base import check_dtypes
from repro_torch.kernels import backend as B

FAULT_FIELD = B.Kernel(
    "fault_field", "fault_field",
    [B.I32, B.VP, B.VP, B.F32, B.U64, B.U64, B.U64, B.U64, B.U64, B.VP, B.VP, B.VP, B.I64, B.VP],
    by_codec=True, codec_key="n_check",
)
N_CHECKS = (1, 8, 15, 24)  # the widths the kernel is built for
BURST_LAUNCHES: dict = {}  # n_check -> launches of the burst kernel
# The words one warp's run of the burst kernel stores (its halo word, the one
# before, is drawn again for its spill): kRunWords = 32 * kRunIters - 1 in
# csrc/fault_field.cu, which must equal it; the tests cut fields at its edges.
RUN_WORDS = 255


def fault_field(f_row, rate, key: int, n_check: int, thresholds=(0, 0, 0, 0)):
    """Flip masks (lo int32, hi int32, check) of the n words of ``f_row``
    ((n,) float32) at ``rate``, a float or an (n,) float32 tensor of
    per-word rates, under the 64-bit Philox ``key``; ``thresholds`` the
    burst's (t3, t2, trd, twa) (ref.burst_thresholds; all 0: no burst)."""
    n = f_row.numel()
    B.check(f_row, torch.float32, "f_row", (n,))
    if n_check not in N_CHECKS:
        raise ValueError(f"n_check must be one of {N_CHECKS}, got {n_check}")
    per_word = isinstance(rate, torch.Tensor)
    if per_word:
        B.check(rate, torch.float32, "rates", (n,))
    lo = torch.empty(n, dtype=torch.int32, device=f_row.device)
    hi = torch.empty_like(lo)
    chk = torch.empty(n, dtype=check_dtypes(n_check)[1], device=f_row.device)
    if n:
        FAULT_FIELD(
            n_check, B.ptr(f_row), B.ptr(rate) if per_word else None,
            0.0 if per_word else float(rate), int(key) & (2**64 - 1), *map(int, thresholds),
            B.ptr(lo), B.ptr(hi), B.ptr(chk), n, B.stream(f_row),
        )
        if any(thresholds):
            BURST_LAUNCHES[n_check] = BURST_LAUNCHES.get(n_check, 0) + 1
    return lo, hi, chk
