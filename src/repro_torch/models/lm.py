"""Decoder LM (the dense and MoE families): parameter construction,
prefill, chunked prefill and greedy decode.

The layer stack is a Python loop over the stacked ``n_groups`` axis (the
reference's ``lax.scan``); protected matrices are ``EccWeight`` leaves whose
layer ``g`` is sliced per step. The cache is updated in place.

Every forward on a position-indexed float cache is one path: the new tokens
of lane b sit at cache positions pos0[b], pos0[b] + 1, ...; their K/V are
written into the cache and they attend the cache
(``layers.chunk_attention``, with the sliding window as a mask). A prefill
is a chunk at position 0, a decode step a chunk of one token, and a scalar
position a vector of equal positions. The reference's own cache layouts
take its own cases: a sliding-window config's cache is a ring of
``sliding_window`` slots (position p in slot p % slots), a ``kv_quant``
config's holds int8 K/V with per-(token, head) scales. There a prefill
attends its fresh, unquantised K/V and then stores them (the last slots'
worth, rolled into ring order, quantised), a decode step writes its token's
slot and attends the (dequantised) cache, and chunks are refused. Logits
go through one product shape (rows zero-padded to ``LOGIT_ROWS``), so a
row's logits do not depend on how many rows the call holds (see
models/layers.py); an MoE layer's plain-weight products do the same
(models/moe.py). Callers that know the positions on the host pass
``kv_len``, a bound on the cache length attended, so the attention reads
no keys past it.
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import base, layers, moe
from repro_torch.models.base import ModelConfig, Spec, params_from_numpy  # noqa: F401


def check_family(cfg: ModelConfig) -> None:
    """Admit the ported families: dense, and moe with an MoE feed-forward
    in every layer."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family is not ported "
                                  "(dense and moe are)")
    if cfg.family == "moe" and cfg.moe_every != 1:
        raise NotImplementedError(
            f"{cfg.name}: moe_every={cfg.moe_every} needs period positions p0..p"
            f"{cfg.moe_every - 1} (dense and MoE layers interleaved), which come with "
            "jamba's hybrid family; only moe_every=1 is ported")


def _norm_spec(cfg):
    p = {"gamma": Spec((cfg.d_model,), "ones")}
    if cfg.norm_type == "layernorm":
        p["beta"] = Spec((cfg.d_model,), "zeros")
    return p


def _attn_spec(cfg):
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": Spec((d, cfg.n_heads * hd)),
        "wk": Spec((d, cfg.n_kv_heads * hd)),
        "wv": Spec((d, cfg.n_kv_heads * hd)),
        "wo": Spec((cfg.n_heads * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = Spec((cfg.n_heads * hd,), "zeros")
        p["bk"] = Spec((cfg.n_kv_heads * hd,), "zeros")
        p["bv"] = Spec((cfg.n_kv_heads * hd,), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = Spec((hd,), "ones")
        p["k_norm"] = Spec((hd,), "ones")
    return p


def _mlp_spec(cfg):
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": Spec((d, f)), "w2": Spec((f, d))}
    if cfg.gated_mlp:
        p["w3"] = Spec((d, f))
    return p


def _moe_spec(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": Spec((d, e)), "w1": Spec((e, d, f)), "w2": Spec((e, f, d))}
    if cfg.gated_mlp:
        p["w3"] = Spec((e, d, f))
    if cfg.shared_expert:
        p["shared_w1"] = Spec((d, f))
        p["shared_w3"] = Spec((d, f))
        p["shared_w2"] = Spec((f, d))
    return p


def _layer_spec(cfg, pos: int):
    p = {"ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg), "attn": _attn_spec(cfg)}
    if cfg.layer_kind(pos)["ffn"] == "moe":
        p["moe"] = _moe_spec(cfg)
    else:
        p["mlp"] = _mlp_spec(cfg)
    return p


def _stack(spec, g):
    return base.tree_map(
        lambda s: Spec((g,) + s.shape, s.init, s.scale), spec,
        is_leaf=lambda x: isinstance(x, Spec),
    )


def init_specs(cfg: ModelConfig):
    check_family(cfg)
    tree = {
        "embed": Spec((cfg.vocab, cfg.d_model)),
        "blocks": {"p0": _stack(_layer_spec(cfg, 0), cfg.n_groups)},
        "final_norm": _norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = Spec((cfg.d_model, cfg.vocab))
    return tree


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` (None: the card); a stacked expert leaf is drawn
    one expert matrix at a time (``base.materialize``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return base.materialize(init_specs(cfg), gen, cfg.param_dtype, dev)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zero decode cache: {"p0": {"k", "v"}} of (G, B, S, Hkv, Dh), S =
    max_len, or min(max_len, sliding_window) slots of a ring; with
    ``kv_quant`` int8 K/V and a float32 "kv_scale" (G, B, S, Hkv, 2)."""
    check_family(cfg)
    dev = resolve_device(device)
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (cfg.n_groups, batch, s, cfg.n_kv_heads, cfg.hd)
    kv_dt = torch.int8 if cfg.kv_quant else cfg.compute_dtype
    c = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
         "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
    if cfg.kv_quant:
        c["kv_scale"] = torch.zeros(shape[:-1] + (2,), dtype=torch.float32, device=dev)
    return {"p0": c}


def _quant_kv(k, v):
    """(B, S, H, hd) -> int8 planes + per-(token, head) scales (B, S, H, 2):
    max|x| / 127 floored at 1e-9, rounded half to even, clipped to 127."""
    def q(x):
        x32 = x.to(torch.float32)
        sc = torch.clamp_min(x32.abs().amax(-1, keepdim=True) / 127.0, 1e-9)
        return torch.clamp(torch.round(x32 / sc), -127, 127).to(torch.int8), sc

    (kq, ks), (vq, vs) = q(k), q(v)
    return kq, vq, torch.cat([ks, vs], dim=-1)


def _dequant_kv(kq, vq, scale, dtype):
    k = kq.to(dtype) * scale[..., 0:1].to(dtype)
    v = vq.to(dtype) * scale[..., 1:2].to(dtype)
    return k, v


def _layer(tree, g: int):
    """Layer ``g`` of a stacked parameter subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, g) for k, v in tree.items()}
    if isinstance(tree, kops.EccWeight):
        return tree.layer(g)
    return tree[g]


LOGIT_ROWS = 16  # rows of every logits product

# The float32 unembedding of each parameter tensor, cast once.
_UNEMBED_F32 = WeakIdKeyDictionary()


def _attention(q, k, v, cfg, *, cache, g, pos0, kv_len, prefill):
    b, s = q.shape[:2]
    w = cfg.sliding_window
    ck, cv = cache["k"][g], cache["v"][g]
    smax = ck.shape[1]
    # a windowed config's cache of at most w slots is a ring
    ring, quant = bool(w) and smax <= w, "kv_scale" in cache
    lanes = torch.arange(b, device=q.device)[:, None]
    if not (ring or quant):
        # As the reference's cache writes, a chunk running past the cache's
        # end lands on its last rows.
        rows = torch.clamp(pos0, max=smax - s)[:, None] + torch.arange(s, device=q.device)
        ck[lanes, rows] = k.to(ck.dtype)
        cv[lanes, rows] = v.to(cv.dtype)
        return layers.chunk_attention(q, ck, cv, pos0, kv_len, window=w)
    if prefill:
        # the fresh, unquantised K/V; then the last smax positions are
        # stored, under a ring position p in slot p % smax
        out = layers.chunk_attention(q, k, v, pos0, s, window=w)
        ks, vs = k[:, -smax:], v[:, -smax:]
        if ring and s >= smax:
            ks, vs = torch.roll(ks, s % smax, 1), torch.roll(vs, s % smax, 1)
        n = ks.shape[1]
        if quant:
            kq, vq, sc = _quant_kv(ks, vs)
            ck[:, :n], cv[:, :n], cache["kv_scale"][g][:, :n] = kq, vq, sc
        else:
            ck[:, :n], cv[:, :n] = ks.to(ck.dtype), vs.to(cv.dtype)
        return out
    if s != 1:
        raise ValueError(f"{cfg.name}: a ring or int8 KV cache takes prefills and one-token "
                         "decode steps, not chunks")
    slot = (pos0 % smax if ring else torch.clamp(pos0, max=smax - 1))[:, None]
    if quant:
        kq, vq, sc = _quant_kv(k, v)
        ck[lanes, slot], cv[lanes, slot], cache["kv_scale"][g][lanes, slot] = kq, vq, sc
    else:
        ck[lanes, slot], cv[lanes, slot] = k.to(ck.dtype), v.to(cv.dtype)
    if ring:  # the ring's first min(pos + 1, smax) slots, all inside the window
        pos0, w = torch.clamp(pos0, max=smax - 1), 0
        kv_len = None if kv_len is None else min(kv_len, smax)
    if quant:  # dequantise the slots the attention reads
        n = smax if kv_len is None else min(smax, layers.pow2_ceil(kv_len))
        ck, cv = _dequant_kv(ck[:, :n], cv[:, :n], cache["kv_scale"][g][:, :n],
                             cfg.compute_dtype)
    return layers.chunk_attention(q, ck, cv, pos0, kv_len, window=w)


def _attn_block(x, p, cfg, *, cache, g, pos0, kv_len, rope, prefill):
    h = layers.apply_norm(x, p["ln1"], cfg.norm_type)
    q, k, v = layers.qkv_proj(h, p["attn"], cfg, rope)
    out = _attention(q, k, v, cfg, cache=cache, g=g, pos0=pos0, kv_len=kv_len, prefill=prefill)
    x = x + layers.out_proj(out, p["attn"])
    h2 = layers.apply_norm(x, p["ln2"], cfg.norm_type)
    if "moe" in p:  # decode (S == 1) routes the batch as one group, else each row
        return x + moe.moe_ffn(h2, p["moe"], cfg)
    return x + layers.mlp(h2, p["mlp"], cfg)


def _embed(params, tokens, cfg):
    return params["embed"][tokens].to(cfg.compute_dtype)


def _unembed_f32(params, cfg):
    """The (D, V) float32 unembedding. A bf16 table is cast once and kept
    while its tensor lives (and is cast again if it is written in place)."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if w.dtype != torch.float32:
        hit = _UNEMBED_F32.get(w)
        if hit is None or hit[0] != w._version:
            hit = (w._version, w.to(torch.float32))
            _UNEMBED_F32[w] = hit
        w = hit[1]
    return w.T if cfg.tie_embeddings else w


def _positions(pos, b: int, device) -> torch.Tensor:
    """A scalar or (B,) position as a (B,) int64 vector on ``device``."""
    if isinstance(pos, torch.Tensor):
        if pos.ndim:
            return pos.to(device=device, dtype=torch.int64)
        pos = int(pos)
    if isinstance(pos, int):
        return torch.full((b,), pos, dtype=torch.int64, device=device)
    return torch.as_tensor(pos, dtype=torch.int64).reshape(b).to(device)


def _kv_bound(pos0, s: int) -> int | None:
    """max(pos0) + s where the positions are on the host, else None."""
    if isinstance(pos0, torch.Tensor) and pos0.device.type != "cpu":
        return None
    return int(torch.as_tensor(pos0).max()) + s


def forward(params, tokens, cfg: ModelConfig, cache, pos0, kv_len: int | None = None,
            prefill: bool = False):
    """Backbone: (B, S) tokens at cache positions pos0 .. pos0 + S - 1 (pos0
    a scalar or (B,)) -> final-norm hidden (B, S, D); writes their K/V into
    the cache in place. ``kv_len`` bounds max(pos0) + S from the host
    (derived when the positions are on the host; else the cache length).
    ``prefill`` (pos0 0) marks a prompt, which a ring or int8 cache stores
    after attending it. An MoE layer routes a one-token forward's batch as
    one dispatch group and each row of a longer one as its own."""
    check_family(cfg)
    if kv_len is None:
        kv_len = _kv_bound(pos0, tokens.shape[1])
    pos0 = _positions(pos0, tokens.shape[0], tokens.device)
    x = _embed(params, tokens, cfg)
    positions = pos0[:, None] + torch.arange(tokens.shape[1], device=x.device)[None, :]
    rope = layers.rope_tables(positions, cfg.hd, cfg.rope_theta)  # once for every layer
    blocks = params["blocks"]["p0"]
    for g in range(cfg.n_groups):
        x = _attn_block(x, _layer(blocks, g), cfg, cache=cache["p0"], g=g, pos0=pos0,
                        kv_len=kv_len, rope=rope, prefill=prefill)
    return layers.apply_norm(x, params["final_norm"], cfg.norm_type)


def _logits(params, hidden, cfg):
    """(..., D) hidden -> (..., V) float32 logits. The rows are zero-padded
    to a multiple of ``LOGIT_ROWS`` and every product is LOGIT_ROWS x D by
    D x V, one shape for every call."""
    un = _unembed_f32(params, cfg)
    n, d = hidden.shape[:-1].numel(), hidden.shape[-1]
    h2 = hidden.new_zeros((-(-n // LOGIT_ROWS) * LOGIT_ROWS, d), dtype=torch.float32)
    h2[:n] = hidden.reshape(n, d)
    out = torch.cat([h2[i : i + LOGIT_ROWS] @ un for i in range(0, h2.shape[0], LOGIT_ROWS)])
    return out[:n].reshape(*hidden.shape[:-1], un.shape[1])


@torch.no_grad()
def prefill(params, tokens, cfg: ModelConfig, cache):
    """Process a prompt, fill the cache. Returns (last-token logits, cache)."""
    hidden = forward(params, tokens, cfg, cache, 0, prefill=True)
    return _logits(params, hidden[:, -1], cfg), cache


@torch.no_grad()
def decode_step(params, tokens, cfg: ModelConfig, cache, pos, kv_len: int | None = None):
    """One decode step of (B, 1) tokens at 0-based position ``pos``: a
    scalar, or a (B,) vector giving every lane its own position (continuous
    batching)."""
    hidden = forward(params, tokens, cfg, cache, pos, kv_len)
    return _logits(params, hidden[:, -1], cfg), cache


def _check_chunkable(cfg: ModelConfig) -> None:
    if cfg.sliding_window or cfg.kv_quant:
        raise ValueError(f"{cfg.name}: chunks need a position-indexed float cache "
                         "(no sliding_window, no kv_quant)")


@torch.no_grad()
def chunk_step(params, tokens, cfg: ModelConfig, cache, pos0, kv_len: int | None = None):
    """Chunked prefill: process ``tokens`` (B, S) whose cache positions start
    at per-lane ``pos0`` ((B,) or scalar), writing their K/V into the cache.
    Returns (last-token logits (B, V), cache)."""
    _check_chunkable(cfg)
    hidden = forward(params, tokens, cfg, cache, pos0, kv_len)
    return _logits(params, hidden[:, -1], cfg), cache


@torch.no_grad()
def chunk_logits(params, tokens, cfg: ModelConfig, cache, pos0, kv_len: int | None = None):
    """Like ``chunk_step`` but returning the full (B, S, V) logits (the
    speculative verify block)."""
    _check_chunkable(cfg)
    hidden = forward(params, tokens, cfg, cache, pos0, kv_len)
    return _logits(params, hidden, cfg), cache


@torch.no_grad()
def sequence_logits(params, tokens, cfg: ModelConfig):
    """Teacher-forced (B, S, V) float32 logits of a fixed token sequence
    (B, S): the paired clean-against-faulty evaluation of core/campaign.py,
    which feeds the same tokens through both parameter sets. The forward is
    the one of every other entry point, on a fresh cache of S positions, so
    protected leaves read through the fused ECC matmul as in serving and the
    last position's logits equal ``prefill``'s on the same tokens bit for
    bit. As the reference's train-mode forward, it is windowed and
    unquantised: a prefill attends its fresh K/V."""
    cache = init_cache(cfg, tokens.shape[0], tokens.shape[1], device=tokens.device)
    hidden = forward(params, tokens, cfg, cache, 0, prefill=True)
    return _logits(params, hidden, cfg)


@torch.no_grad()
def greedy_decode_loop(params, tok0, cfg: ModelConfig, cache, start_pos: int, n_steps: int):
    """Greedy-decode ``n_steps`` tokens after ``tok0`` (B, 1).
    Returns (tokens (B, n_steps) int64, cache)."""
    tok, out = tok0, []
    pos = _positions(start_pos, tok0.shape[0], tok0.device)
    for i in range(n_steps):
        logits, cache = decode_step(params, tok, cfg, cache, pos + i,
                                    _kv_bound(start_pos, i + 1))
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    if not out:
        return torch.zeros(tok0.shape[0], 0, dtype=torch.int64, device=tok0.device), cache
    return torch.cat(out, dim=1), cache
