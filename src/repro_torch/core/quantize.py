"""Int8 symmetric quantization of the weights kept in the ECC memory: 8 int8
values form one 64-bit codeword (two uint32 lanes); and the raw-bit word
packing of any tensor that the memory domain stores."""

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


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def array_to_words(t: torch.Tensor):
    """The raw bits of a tensor of any dtype -> (lo, hi) int32 word planes
    (n,) on the tensor's device, and its byte count. Bytes are taken in
    memory order, zero-padded to a whole 64-bit word."""
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    nbytes = raw.numel()
    pad = (-nbytes) % 8
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    words = raw.view(torch.int32).reshape(-1, 2)
    return words[:, 0].contiguous(), words[:, 1].contiguous(), nbytes


def words_to_array(lo: torch.Tensor, hi: torch.Tensor, nbytes: int, shape, dtype):
    """Inverse of ``array_to_words``: word planes -> a tensor of ``shape``
    and ``dtype`` with the same bits, on the planes' device."""
    raw = torch.stack([lo.reshape(-1), hi.reshape(-1)], dim=-1).reshape(-1).view(torch.uint8)
    return raw[:nbytes].view(dtype).reshape(shape)
