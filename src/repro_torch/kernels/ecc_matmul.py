"""Launch wrapper of the fused decode + dequant + matmul kernel
(csrc/ecc_matmul.cu)."""

from __future__ import annotations

import functools

import torch

from repro_torch.codes import Codec
from repro_torch.kernels import backend as B

ECC_MATMUL = B.Kernel("ecc_matmul", "ecc_matmul", [B.VP] * 7 + [B.I32] * 3 + [B.VP])

# kDecodeMaxM of csrc/ecc_matmul.cu: calls with at most this many rows run
# the decode kernel while its shared memory fits, the others the tiled kernel.
DECODE_MAX_M = 16
# The __global__ functions behind the one launcher (profiler event names).
GLOBAL_KERNELS = {"decode": "ecc_matmul_decode_kernel", "tiled": "ecc_matmul_kernel"}
# Launches per kernel behind the launcher since the last reset.
LAUNCHES_BY_KERNEL = {"decode": 0, "tiled": 0}


@functools.lru_cache(maxsize=None)
def kernel_for(m: int, k: int) -> str:
    """Which kernel an (m, k) call launches, as the launcher decides it
    (``ecc_matmul_kernel_for`` of csrc/ecc_matmul.cu): "decode" for at most
    ``DECODE_MAX_M`` rows while its shared memory fits (K up to 8,832),
    else "tiled". Asks the built library, so it needs the CUDA toolkit."""
    fn = B.library("ecc_matmul").ecc_matmul_kernel_for
    fn.argtypes, fn.restype = [B.I32, B.I32], B.I32
    return ("decode", "tiled")[fn(m, k // 8)]


def ecc_matmul(x, lo, hi, check, scale, *, codec: Codec):
    """x (M, K) float32 in natural layout, planes (K/8, N) -> (M, N) float32
    ``scale * (x @ W)``.

    One launch, of the kernel ``kernel_for(M, K)`` names. M <=
    ``DECODE_MAX_M`` (16) runs the decode kernel (8 output columns per
    block, one warp per chunk of 64 K values), larger M, or K above 8,832,
    the tiled kernel (32-, 64- or 128-row tiles of 8-32 columns, each plane
    word decoded once per block). Both run one chunk
    chain of bf16 tensor-core MMAs on an exact three-piece split of x,
    folded over the chunks in ascending order, so a row's output is the same
    floats whatever M the call has."""
    if x.ndim != 2 or lo.ndim != 2:
        raise ValueError(f"expected 2D x and planes, got {x.shape} and {lo.shape}")
    m, k = x.shape
    k8, n = lo.shape
    if k != 8 * k8:
        raise ValueError(f"x has K={k}, planes hold K={8 * k8}")
    B.check(x, torch.float32, "x")
    B.check(lo, torch.int32, "lo", (k8, n))
    B.check(hi, torch.int32, "hi", (k8, n))
    B.check(check, torch.uint8, "check", (k8, n))
    B.check(scale, torch.float32, "scale", (n,))
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    if m and n:
        LAUNCHES_BY_KERNEL[kernel_for(m, k)] += 1
        ECC_MATMUL(
            B.ptr(x), B.ptr(lo), B.ptr(hi), B.ptr(check), B.ptr(scale), B.ptr(out),
            B.ptr(codec.kernel_tables(x.device)), m, k8, n, B.stream(x),
        )
    return out
