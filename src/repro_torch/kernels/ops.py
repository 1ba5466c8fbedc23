"""Public kernel entry points: dispatch on the tensors' device.

CPU tensors take the plain version (kernels/ref.py); CUDA tensors launch the
hand-written kernel (kernels/inject_scrub.py, secded.py, ecc_matmul.py,
paged_gather.py, fault_inject.py) or raise. Planes of any shape are
flattened; the kernels need no padded layout, so no pad correction of the
clean counter arises.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import codes
from repro_torch.kernels import backend
from repro_torch.kernels import ecc_matmul as _mm
from repro_torch.kernels import fault_inject as _fi
from repro_torch.kernels import inject_scrub as _isc
from repro_torch.kernels import paged_gather as _pg
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import secded as _secded

KERNELS = {
    "inject_scrub": _isc.INJECT_SCRUB,
    "inject_scrub_domains": _isc.INJECT_SCRUB_DOMAINS,
    "decode": _secded.DECODE,
    "ecc_matmul": _mm.ECC_MATMUL,
    "encode": _secded.ENCODE,
    "gather_scrub": _pg.GATHER_SCRUB,
    "inject": _fi.INJECT,
}


def reset_launch_count() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset (CPU calls, which
    run the plain versions, launch nothing)."""
    return {name: k.launches for name, k in KERNELS.items()}


def _flat(*planes):
    return [p.reshape(-1) for p in planes]


def encode(lo, hi, *, codec: str = codes.DEFAULT_CODEC):
    """ECC check plane (uint8) for word planes of any shape."""
    flo, fhi = _flat(lo, hi)
    if backend.dispatch(flo, fhi) == "cpu":
        out = _ref.encode_ref(flo, fhi, codec)
    else:
        out = _secded.encode(flo, fhi, codec=codes.get(codec))
    return out.reshape(lo.shape)


def encode_commit(payload, row_base, row_words: int, lo, hi, check, *,
                  codec: str = codes.DEFAULT_CODEC) -> None:
    """Encode float32 payload rows (R, 2 * row_words) and scatter word j of
    row r to index ``row_base[r] + j`` of the flat planes lo/hi/check, in
    place (one launch on the card: split, encode and scatter)."""
    if backend.dispatch(payload, row_base, lo, hi, check) == "cpu":
        _ref.encode_commit_ref(payload, row_base, row_words, lo, hi, check, codec)
    else:
        _secded.encode_commit(payload, row_base, row_words, lo, hi, check,
                              codec=codes.get(codec))


def gather_scrub_pages(lo, hi, parity, page_ids, words_per_page: int, *,
                       codec: str = codes.DEFAULT_CODEC):
    """Scrub-on-read of the pages ``page_ids`` of flat arena planes, written
    back in place: (payload (P, 2 * words_per_page) float32, counters (P, 8)
    int32 with lanes 0..2 = clean, corrected, detected)."""
    if backend.dispatch(lo, hi, parity, page_ids) == "cpu":
        return _ref.gather_scrub_ref(lo, hi, parity, page_ids, words_per_page, codec)
    return _pg.gather_scrub(lo, hi, parity, page_ids, words_per_page, codec=codes.get(codec))


def decode(lo, hi, parity, *, codec: str = codes.DEFAULT_CODEC):
    """ECC decode of planes of any shape -> (lo', hi', status int32)."""
    flo, fhi, fpar = _flat(lo, hi, parity)
    if backend.dispatch(flo, fhi, fpar) == "cpu":
        out = _ref.decode_ref(flo, fhi, fpar, codec)
    else:
        out = _secded.decode(flo, fhi, fpar, codec=codes.get(codec))
    return tuple(t.reshape(lo.shape) for t in out)


def inject(lo, hi, parity, mlo, mhi, mparity):
    """Read-time fault injection: XOR flip masks into planes of any shape ->
    (faulty lo, hi, parity)."""
    planes = _flat(lo, hi, parity, mlo, mhi, mparity)
    if backend.dispatch(*planes) == "cpu":
        out = _ref.inject_ref(*planes)
    else:
        out = _fi.inject(*planes)
    return tuple(t.reshape(lo.shape) for t in out)


def inject_scrub(lo, hi, parity, mlo, mhi, mparity, *,
                 codec: str = codes.DEFAULT_CODEC, reencode: bool = False):
    """Fused inject + scrub -> (faulty lo, hi, parity, counters (8,) int32),
    counters in telemetry.COUNTER_FIELDS order."""
    planes = _flat(lo, hi, parity, mlo, mhi, mparity)
    if backend.dispatch(*planes) == "cpu":
        out = _ref.inject_scrub_ref(*planes, reencode=reencode, codec=codec)
    else:
        out = _isc.inject_scrub(*planes, codec=codes.get(codec), reencode=reencode)
    return tuple(t.reshape(lo.shape) for t in out[:3]) + (out[3],)


def inject_scrub_domains(lo, hi, parity, mlo, mhi, mparity, domain_ids, n_domains: int,
                         *, codec: str = codes.DEFAULT_CODEC, reencode: bool = False):
    """Fused inject + scrub with one counter row per memory domain:
    (faulty lo, hi, parity, counters (n_domains, 8) int32). Words whose
    domain id lies outside [0, n_domains) are counted in no row."""
    planes = _flat(lo, hi, parity, mlo, mhi, mparity, domain_ids)
    if backend.dispatch(*planes) == "cpu":
        out = _ref.inject_scrub_domains_ref(
            *planes, n_domains, reencode=reencode, codec=codec
        )
    else:
        out = _isc.inject_scrub_domains(
            *planes, n_domains, codec=codes.get(codec), reencode=reencode
        )
    return tuple(t.reshape(lo.shape) for t in out[:3]) + (out[3],)


@dataclasses.dataclass
class EccWeight:
    """SECDED-encoded int8 weight matrix (K, N) as word planes (K/8, N), or a
    layer-stacked (G, K/8, N) stack of them."""

    lo: torch.Tensor  # int32 bit patterns
    hi: torch.Tensor
    parity: torch.Tensor  # uint8
    scale: torch.Tensor  # per-column (N,) or stacked (G, N) float32
    k: int
    n: int

    def layer(self, g: int) -> "EccWeight":
        """The 2D weight of layer ``g`` of a stacked leaf."""
        return dataclasses.replace(
            self, lo=self.lo[g], hi=self.hi[g], parity=self.parity[g], scale=self.scale[g]
        )


def pack_ecc_weights(w: torch.Tensor, axis_scale: int | None = 1) -> EccWeight:
    """Quantize a float (K, N) weight to int8 and SECDED-encode it, on the
    weight's device: the bytes are packed into words by plain tensor code,
    the check plane comes from ``encode`` (the kernel on the card)."""
    from repro_torch.core import quantize as q

    k, n = w.shape
    assert k % 8 == 0, f"K={k} must be a multiple of 8 (64-bit codewords)"
    qw, scale = q.quantize(w, axis=axis_scale)
    lo, hi = _ref.pack_words(qw)
    parity = encode(lo, hi)
    return EccWeight(lo, hi, parity, scale.reshape(-1) if axis_scale is not None else scale, k, n)


def permute_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """The reference kernel's activation permutation (x_perm[..., 8i+j] =
    x[..., j*K/8 + i]); the CUDA kernel folds it into its indexing."""
    k8 = k // 8
    lead = x.shape[:-1]
    return x.reshape(*lead, 8, k8).transpose(-1, -2).reshape(*lead, k)


def ecc_matmul(x: torch.Tensor, w: EccWeight, *, fuse: bool = True) -> torch.Tensor:
    """``scale * (x @ decode(w))`` with ECC correction on the read path;
    float32 result of shape (..., N).

    fuse=True : one fused decode + dequant + matmul (the kernel on the card);
    fuse=False: the naive read, a decode pass that materialises the corrected
                int8 weights, then a float32 ``torch.matmul``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, w.k).to(torch.float32).contiguous()
    if not fuse:
        lo, hi, _ = decode(w.lo, w.hi, w.parity)
        out = (x2 @ _ref.unpack_ecc_weights(lo, hi).to(torch.float32)) * w.scale
    elif backend.dispatch(x2, w.lo, w.hi, w.parity, w.scale) == "cpu":
        out = _ref.ecc_matmul_ref(x2, w.lo, w.hi, w.parity, w.scale)
    else:
        out = _mm.ecc_matmul(x2, w.lo, w.hi, w.parity, w.scale, codec=codes.get("secded72"))
    return out.reshape(*lead, w.n)


def scrub(w: EccWeight) -> torch.Tensor:
    """Memory-scrubber pass: decode every plane word, return the status."""
    return decode(w.lo, w.hi, w.parity)[2]
