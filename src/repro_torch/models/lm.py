"""Dense decoder LM: parameter construction, prefill and greedy decode.

The layer stack is a Python loop over the stacked ``n_groups`` axis (the
reference's ``lax.scan``); protected matrices are ``EccWeight`` leaves whose
layer ``g`` is sliced per step. The decode cache is updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import base, layers
from repro_torch.models.base import ModelConfig, Spec, params_from_numpy  # noqa: F401


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: only the dense family is ported")


def _norm_spec(cfg):
    return {"gamma": Spec((cfg.d_model,), "ones")}


def _attn_spec(cfg):
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": Spec((d, cfg.n_heads * hd)),
        "wk": Spec((d, cfg.n_kv_heads * hd)),
        "wv": Spec((d, cfg.n_kv_heads * hd)),
        "wo": Spec((cfg.n_heads * hd, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = Spec((hd,), "ones")
        p["k_norm"] = Spec((hd,), "ones")
    return p


def _mlp_spec(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {"w1": Spec((d, f)), "w2": Spec((f, d)), "w3": Spec((d, f))}


def _stack(spec, g):
    return base.tree_map(
        lambda s: Spec((g,) + s.shape, s.init, s.scale), spec,
        is_leaf=lambda x: isinstance(x, Spec),
    )


def init_specs(cfg: ModelConfig):
    _check_dense(cfg)
    layer = {
        "ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg),
        "attn": _attn_spec(cfg), "mlp": _mlp_spec(cfg),
    }
    tree = {
        "embed": Spec((cfg.vocab, cfg.d_model)),
        "blocks": {"p0": _stack(layer, cfg.n_groups)},
        "final_norm": _norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = Spec((cfg.d_model, cfg.vocab))
    return tree


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` (None: the card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return base.materialize(init_specs(cfg), gen, cfg.param_dtype, dev)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zero decode cache: {"p0": {"k", "v"}} of (G, B, S, Hkv, Dh)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_groups, batch, max_len, cfg.n_kv_heads, cfg.hd)
    z = lambda: torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
    return {"p0": {"k": z(), "v": z()}}


def _layer(tree, g: int):
    """Layer ``g`` of a stacked parameter subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, g) for k, v in tree.items()}
    if isinstance(tree, kops.EccWeight):
        return tree.layer(g)
    return tree[g]


def _attn_block(x, p, cfg, *, mode, cache, g, pos):
    b, s, _ = x.shape
    h = layers.rms_norm(x, p["ln1"]["gamma"])
    q, k, v = layers.qkv_proj(h, p["attn"], cfg)
    if mode == "decode":
        positions = torch.full((b, 1), pos, device=x.device)
    else:
        positions = torch.arange(s, device=x.device)[None, :]
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        ck, cv = cache["k"][g], cache["v"][g]
        smax = ck.shape[1]
        slot = min(pos, smax - 1)
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        out = layers.decode_attention(q, ck, cv, pos + 1)
    else:
        ck, cv = cache["k"][g], cache["v"][g]
        smax = ck.shape[1]
        ks, vs = k[:, -smax:], v[:, -smax:]
        ck[:, : ks.shape[1]] = ks.to(ck.dtype)
        cv[:, : vs.shape[1]] = vs.to(cv.dtype)
        out = layers.full_attention(q, k, v)
    x = x + layers.out_proj(out, p["attn"])
    h2 = layers.rms_norm(x, p["ln2"]["gamma"])
    return x + layers.mlp(h2, p["mlp"])


def _embed(params, tokens, cfg):
    return params["embed"][tokens].to(cfg.compute_dtype)


def _unembed_matrix(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params, tokens, cfg: ModelConfig, cache, *, pos: int = 0, mode="prefill"):
    """Backbone: (B, S) tokens -> final-norm hidden (B, S, D); ``prefill``
    (S prompt tokens) and ``decode`` (one token at ``pos``) write the cache
    in place."""
    _check_dense(cfg)
    x = _embed(params, tokens, cfg)
    blocks = params["blocks"]["p0"]
    for g in range(cfg.n_groups):
        x = _attn_block(x, _layer(blocks, g), cfg, mode=mode, cache=cache["p0"], g=g, pos=pos)
    return layers.rms_norm(x, params["final_norm"]["gamma"])


def _logits(params, hidden, cfg):
    un = _unembed_matrix(params, cfg)
    return hidden.to(torch.float32) @ un.to(torch.float32)


@torch.no_grad()
def prefill(params, tokens, cfg: ModelConfig, cache):
    """Process a prompt, fill the cache. Returns (last-token logits, cache)."""
    hidden = forward(params, tokens, cfg, cache, mode="prefill")
    return _logits(params, hidden[:, -1], cfg), cache


@torch.no_grad()
def decode_step(params, tokens, cfg: ModelConfig, cache, pos: int):
    """One decode step of (B, 1) tokens at 0-based position ``pos``."""
    hidden = forward(params, tokens, cfg, cache, pos=int(pos), mode="decode")
    return _logits(params, hidden[:, -1], cfg), cache


@torch.no_grad()
def greedy_decode_loop(params, tok0, cfg: ModelConfig, cache, start_pos: int, n_steps: int):
    """Greedy-decode ``n_steps`` tokens after ``tok0`` (B, 1).
    Returns (tokens (B, n_steps) int64, cache)."""
    tok, out = tok0, []
    for i in range(n_steps):
        logits, cache = decode_step(params, tok, cfg, cache, start_pos + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    if not out:
        return torch.zeros(tok0.shape[0], 0, dtype=torch.int64, device=tok0.device), cache
    return torch.cat(out, dim=1), cache
