"""Public kernel entry points: dispatch on the tensors' device.

CPU tensors take the plain version (kernels/ref.py); CUDA tensors launch the
hand-written kernel (kernels/inject_scrub.py, secded.py, ecc_matmul.py,
paged_gather.py, fault_inject.py, fault_field.py) or raise. Planes of any shape are
flattened; the kernels need no padded layout, so no pad correction of the
clean counter arises.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import codes
from repro_torch.kernels import backend
from repro_torch.kernels import ecc_matmul as _mm
from repro_torch.kernels import fault_field as _ff
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
    "fault_field": _ff.FAULT_FIELD,
}


def reset_launch_count() -> None:
    for k in KERNELS.values():
        k.reset()
    _ff.BURST_LAUNCHES.clear()
    _mm.LAUNCHES_BY_KERNEL.update(decode=0, tiled=0)


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset (CPU calls, which
    run the plain versions, launch nothing)."""
    return {name: k.launches for name, k in KERNELS.items()}


def launch_counts_by_codec() -> dict:
    """{kernel: {codec name: launches}} of the codec-generic kernels since
    the last reset."""
    out = {}
    for name, k in KERNELS.items():
        if k.by_codec:
            by_id = {getattr(codes.get(c), k.codec_key): c for c in codes.names()}
            out[name] = {by_id[i]: n for i, n in sorted(k.launches_by_codec.items())}
    return out


def burst_launch_counts() -> dict:
    """{codec name: launches} of the fault field's burst kernel since the
    last reset (they are also counted in ``launch_counts()["fault_field"]``)."""
    by_nc = {codes.get(c).n_check: c for c in codes.names()}
    return {by_nc[nc]: n for nc, n in sorted(_ff.BURST_LAUNCHES.items())}


def ecc_matmul_launches_by_kernel() -> dict:
    """{"decode": n, "tiled": n}: the fused matmul's launches since the last
    reset by the kernel each took (they sum to
    ``launch_counts()["ecc_matmul"]``)."""
    return dict(_mm.LAUNCHES_BY_KERNEL)


def _flat(*planes):
    return [p.reshape(-1) for p in planes]


def encode(lo, hi, *, codec: str = codes.DEFAULT_CODEC):
    """ECC check plane (the codec's ``check_torch_dtype``) for word planes of
    any shape."""
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


# Words a CPU plain fault-field draw takes at a time: its (64 + n_check) x
# chunk int64 transients stay in the caches (2^18 words run 4x slower).
FIELD_CPU_CHUNK = 1 << 15


def fault_field(f_row, rate, key: int, n_check: int, *, burst=None,
                chunk_words: int = FIELD_CPU_CHUNK):
    """Flip masks (lo int32, hi int32, check) of a fault field's words:
    ``f_row`` (n,) float32 row weakness, ``rate`` a float or an (n,) float32
    tensor of per-word rates, ``key`` the field's 64-bit Philox key,
    ``burst`` a ``scenario.BurstProfile`` (None: i.i.d. flips) whose
    expansion runs in the same launch. One launch on the card; the plain
    version draws ``chunk_words`` words at a time, and the masks do not
    depend on the chunking."""
    per_word = isinstance(rate, torch.Tensor)
    thresholds = _ref.burst_thresholds(burst)
    if backend.dispatch(f_row, *((rate,) if per_word else ())) == "cuda":
        return _ff.fault_field(f_row, rate, key, n_check, thresholds)
    return _ref.fault_field_plain(f_row, rate, key, n_check, thresholds,
                                  chunk_words=chunk_words)


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
                         *, codec: str = codes.DEFAULT_CODEC, reencode: bool = False,
                         out=None):
    """Fused inject + scrub with one counter row per memory domain:
    (faulty lo, hi, parity, counters (n_domains, 8) int32). Words whose
    domain id lies outside [0, n_domains) are counted in no row. ``out``
    (flat lo, hi, parity planes on the same device) receives the faulty
    planes, which are then returned."""
    planes = _flat(lo, hi, parity, mlo, mhi, mparity, domain_ids)
    if backend.dispatch(*planes, *(out or ())) == "cpu":
        res = _ref.inject_scrub_domains_ref(
            *planes, n_domains, reencode=reencode, codec=codec
        )
        if out is not None:
            for o, r in zip(out, res[:3]):
                o.copy_(r)
            res = tuple(out) + (res[3],)
    else:
        res = _isc.inject_scrub_domains(
            *planes, n_domains, codec=codes.get(codec), reencode=reencode, out=out
        )
    return tuple(t.reshape(lo.shape) for t in res[:3]) + (res[3],)


@dataclasses.dataclass
class EccWeight:
    """ECC-encoded int8 weight matrix (K, N) as word planes (K/8, N), or a
    layer-stacked (G, K/8, N) stack of them. The fused matmul reads SECDED
    planes; a plane store's codec groups carry other codecs' check planes."""

    lo: torch.Tensor  # int32 bit patterns
    hi: torch.Tensor
    parity: torch.Tensor  # the codec's check dtype (uint8 for SECDED)
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
