"""PyTorch + CUDA port of the ECC-undervolting reproduction.

The inline-SECDED serving engine (``repro_torch.serving.engine``) on an
NVIDIA H100: the weight-plane arena, the fused inject+scrub voltage step,
the DED-canary rail controllers and the fused decode+dequant+matmul read
path, each hot loop a hand-written CUDA kernel (``repro_torch.kernels``)
with a plain PyTorch version beside it for CPU tensors.
"""
