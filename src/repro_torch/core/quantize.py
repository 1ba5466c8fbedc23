"""Int8 symmetric quantization of the weights kept in the ECC memory: 8 int8
values form one 64-bit codeword (two uint32 lanes)."""

from __future__ import annotations

import torch


def quantize(x: torch.Tensor, axis: int | None = None):
    """Symmetric int8 quantization -> (q int8, scale float32).

    ``axis`` keeps one scale per slice along it (e.g. per output channel);
    None means one scale for the whole tensor. Rounds half to even.
    """
    x = x.to(torch.float32)
    if axis is None:
        absmax = x.abs().amax()
    else:
        dims = tuple(i for i in range(x.ndim) if i != axis)
        absmax = x.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale

