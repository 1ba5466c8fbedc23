"""Memory domains of the multi-rail arena.

The arena is partitioned into named voltage domains; each gets its own rail,
fault fields and counter row. ``domain_of`` classifies a parameter leaf key;
substrings are matched in order, so "['blocks']['p0']['attn']['wq']" lands
in "attention" before the "mlp" patterns are consulted.
"""

from __future__ import annotations

from repro_torch import codes
from repro_torch.codes import DEFAULT_CODEC

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
