"""Input shapes of the dry run, and the memory domains of the multi-rail
arena.

Every LM-family arch is paired with four shapes:
  train_4k    seq 4096,   global_batch 256  -> train_step
  prefill_32k seq 32768,  global_batch 32   -> prefill_step
  decode_32k  seq 32768 (KV), global_batch 128 -> serve_step (1 new token)
  long_500k   seq 524288 (KV), global_batch 1  -> serve_step; sub-quadratic
              archs only (rwkv6, mixtral's window, jamba's hybrid)
``input_specs`` and ``cache_struct`` give tensors on the meta device:
shapes and dtypes, nothing allocated.

The arena is partitioned into named voltage domains; each gets its own rail,
fault fields and counter row. ``domain_of`` classifies a parameter leaf key;
substrings are matched in order, so "['blocks']['p0']['attn']['wq']" lands
in "attention" before the "mlp" patterns are consulted.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import codes
from repro_torch.codes import DEFAULT_CODEC


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# Sub-quadratic bar for long_500k: SSM / SWA / hybrid only.
LONG_CONTEXT_ARCHS = {"rwkv6-3b", "mixtral-8x22b", "jamba-1.5-large-398b"}

MEMORY_DOMAINS: tuple = ("embedding", "attention", "mlp", "kv")

_DOMAIN_PATTERNS: tuple = (
    ("kv", ("kv", "cache")),
    ("embedding", ("embed", "unembed", "vocab")),
    ("attention", ("attn", "attention", "w_r", "w_k", "w_v", "w_g", "w_o")),
    ("mlp", ("mlp", "ffn", "moe", "expert", "in_proj", "out_proj")),
)


def domain_of(key: str, default: str = "mlp") -> str:
    """Map a parameter leaf key to its memory domain."""
    low = key.lower()
    for name, pats in _DOMAIN_PATTERNS:
        if any(p in low for p in pats):
            return name
    return default


def domain_codecs(overrides=None) -> dict:
    """{domain: codec name} from None (defaults), one codec name, or a
    {domain: name} mapping; names and domains are validated."""
    out = {d: DEFAULT_CODEC for d in MEMORY_DOMAINS}
    if isinstance(overrides, str):
        out = {d: overrides for d in out}
    elif overrides is not None:
        for d, name in dict(overrides).items():
            assert d in out, f"unknown memory domain {d!r}; known: {sorted(out)}"
            out[d] = str(name)
    for name in out.values():
        codes.get(name)
    return out


def rail_policy(name: str) -> str:
    """Validate a mesh rail policy name: ``uniform`` (one voltage per domain
    on every chip, locked at the worst shard's first DED) or ``per_shard``
    (each chip walks to its own V_min)."""
    from repro_torch.core.controller import RAIL_POLICIES

    name = str(name)
    assert name in RAIL_POLICIES, f"unknown rail policy {name!r}; known: {RAIL_POLICIES}"
    return name


def supports_paged_kv(cfg) -> bool:
    """Whether the paged SECDED KV cache (core/kvpages.py) covers this arch:
    every mixer full-context attention with a position-indexed cache. SWA
    ring buffers and quantized caches keep their own layouts, and codebook
    decoders interleave tokens."""
    all_attn = all(cfg.layer_kind(j)["mixer"] == "attn" for j in range(cfg.period))
    return all_attn and not cfg.sliding_window and not cfg.kv_quant and not cfg.n_codebooks


def supported_shapes(arch: str) -> list:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        names.append("long_500k")
    return names


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok_struct(cfg, b: int, s: int) -> torch.Tensor:
    if cfg.n_codebooks:
        return _meta((b, cfg.n_codebooks, s), torch.int32)
    return _meta((b, s), torch.int32)


def input_specs(cfg, shape_name: str, *, batch_override: int = 0) -> dict:
    """Meta-tensor stand-ins for every input of the step function."""
    sh = SHAPES[shape_name]
    b = batch_override or sh.global_batch
    s = sh.seq_len
    if sh.kind == "train":
        specs = {"tokens": _tok_struct(cfg, b, s), "labels": _tok_struct(cfg, b, s)}
    elif sh.kind == "prefill":
        specs = {"tokens": _tok_struct(cfg, b, s), "cache": cache_struct(cfg, b, s)}
    else:  # decode: one new token against a seq_len-deep cache or state
        specs = {"tokens": _tok_struct(cfg, b, 1), "cache": cache_struct(cfg, b, s),
                 "pos": _meta((), torch.int32)}
    if cfg.family == "vlm":
        specs["img"] = _meta((b, cfg.n_img_tokens, cfg.d_model), cfg.compute_dtype)
    return specs


def cache_struct(cfg, batch: int, max_len: int):
    """The decode cache's tree on the meta device (nothing allocated)."""
    from repro_torch.models import lm

    return lm.init_cache(cfg, batch, max_len, device="meta", img_tokens=cfg.n_img_tokens)
