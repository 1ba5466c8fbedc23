"""Decoder LM (the dense, MoE, ssm, hybrid, vlm and audio families):
parameter construction, prefill, chunked prefill and greedy decode.

The layer stack is a Python loop over the stacked ``n_groups`` axis (the
reference's ``lax.scan``), and inside each group over its period positions
p0, p1, ... (jamba's eight layers, an MoE config's ``moe_every``); protected
matrices are ``EccWeight`` leaves whose layer ``g`` is sliced per step. The
cache is updated in place. A recurrent mixer (models/rwkv6.py,
models/mamba.py) keeps a per-lane state in place of K/V: a prefill scans
from a zero state, a one-token decode step advances the state, and chunks
are refused. A vlm period ends in a gated cross-attention layer over the
image tokens: a prefill projects the image (``img``, (B, T, D)) into that
layer's K/V cache of T slots and a decode step attends the cached K/V. An
audio config reads (B, K, S) tokens of K codebooks, sums their embeddings
with a sinusoid of the position and returns (B, K, V) logits; it decodes at
one scalar position. Where the reference fails on these families (a
protected cross K/V projection, chunks, a vector audio position), the port
raises ``ValueError`` before any launch.

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

Training has its own forward (``train_forward``, ``train_loss``): no
cache, autograd through plain products, the reference's train-mode
attention forms (``layers.full_attention``, ``flash_attention``,
``banded_attention``) in place of the batch-invariant cache path, the
MoE's aux loss, remat per layer group, and the cross-entropy in sequence
chunks against the float32 unembedding. The serving entry points above
stay ``no_grad`` and do not change.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import base, layers, mamba, moe, rwkv6
from repro_torch.models.base import ModelConfig, Spec, params_from_numpy  # noqa: F401


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_family(cfg: ModelConfig) -> None:
    """Admit the ported families: dense, moe (an MoE feed-forward at every
    ``moe_every``-th period position), ssm (rwkv6), hybrid (mamba with
    attention and MoE, jamba), vlm (a cross-attention layer ending every
    period of ``cross_attn_every``) and audio (``n_codebooks`` codebooks);
    refuse any other. A depth that is not a whole number of periods is
    refused, as the reference asserts."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family is not ported "
                                  f"({', '.join(FAMILIES)} are)")
    if cfg.period < 1 or cfg.n_layers % cfg.period:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a whole number of "
                         f"periods of {cfg.period} layers (period positions p0..p"
                         f"{cfg.period - 1})")


def recurrent(cfg: ModelConfig) -> bool:
    """Whether some period position has a recurrent mixer (rwkv or mamba),
    whose per-lane state takes the place of a KV cache."""
    return any(cfg.layer_kind(j)["mixer"] in ("rwkv", "mamba") for j in range(cfg.period))


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


def _mamba_spec(cfg):
    d, di, ds, k = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    dtr = max(1, d // 16)
    return {
        "in_proj": Spec((d, 2 * di)),
        "conv_w": Spec((di, k), scale=0.5),
        "conv_b": Spec((di,), "zeros"),
        "x_proj": Spec((di, dtr + 2 * ds)),
        "dt_proj": Spec((dtr, di)),
        "dt_bias": Spec((di,), "zeros"),
        "a_log": Spec((di, ds), "decay"),
        "d_skip": Spec((di,), "ones"),
        "out_proj": Spec((di, d)),
    }


def _rwkv_tm_spec(cfg):
    d = cfg.d_model
    return {
        "mu_base": Spec((d,), "zeros"),
        "mix_a": Spec((d, rwkv6.N_MIX * rwkv6.LORA_MIX)),
        "mix_b": Spec((rwkv6.N_MIX, rwkv6.LORA_MIX, d)),
        "mu_five": Spec((rwkv6.N_MIX, d), "zeros"),
        "w_r": Spec((d, d)),
        "w_k": Spec((d, d)),
        "w_v": Spec((d, d)),
        "w_g": Spec((d, d)),
        "w_o": Spec((d, d)),
        "w_base": Spec((d,), "decay"),
        "decay_a": Spec((d, rwkv6.LORA_DECAY)),
        "decay_b": Spec((rwkv6.LORA_DECAY, d)),
        "u": Spec((d,), "zeros"),
        "ln_x_g": Spec((d,), "ones"),
        "ln_x_b": Spec((d,), "zeros"),
    }


def _rwkv_cm_spec(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": Spec((d,), "zeros"),
        "mu_r": Spec((d,), "zeros"),
        "w_k": Spec((d, f)),
        "w_v": Spec((f, d)),
        "w_r": Spec((d, d)),
    }


_MIXER_SPECS = {"attn": ("attn", _attn_spec), "cross": ("attn", _attn_spec),
                "mamba": ("mamba", _mamba_spec), "rwkv": ("tm", _rwkv_tm_spec)}
_FFN_SPECS = {"moe": ("moe", _moe_spec), "rwkv_cm": ("cm", _rwkv_cm_spec),
              "mlp": ("mlp", _mlp_spec)}


def _layer_spec(cfg, pos: int):
    kind = cfg.layer_kind(pos)
    p = {"ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg)}
    for key, spec in (_MIXER_SPECS[kind["mixer"]], _FFN_SPECS[kind["ffn"]]):
        p[key] = spec(cfg)
    if kind["mixer"] == "cross":  # tanh gates of the attention and the MLP
        p["gate_attn"] = Spec((1,), "zeros")
        p["gate_ffn"] = Spec((1,), "zeros")
    return p


def _stack(spec, g):
    return base.tree_map(
        lambda s: Spec((g,) + s.shape, s.init, s.scale), spec,
        is_leaf=lambda x: isinstance(x, Spec),
    )


def init_specs(cfg: ModelConfig):
    """The parameter spec tree; an audio config's embedding is (K, V, D)
    and its head (K, D, V), one table per codebook."""
    check_family(cfg)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    tree = {
        "embed": Spec(books + (cfg.vocab, cfg.d_model)),
        "blocks": {f"p{j}": _stack(_layer_spec(cfg, j), cfg.n_groups)
                   for j in range(cfg.period)},
        "final_norm": _norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = Spec(books + (cfg.d_model, cfg.vocab))
    return tree


def param_count(cfg: ModelConfig) -> tuple[int, int]:
    """Exact (total, active) parameter counts from the spec tree: a token
    reads ``top_k`` of the ``n_experts`` matrices of a stacked expert leaf."""
    total = active = 0
    for key, s in base.flatten(init_specs(cfg), is_leaf=lambda x: isinstance(x, Spec)):
        n = math.prod(s.shape)
        total += n
        expert = "['moe']" in key and len(s.shape) >= 4
        active += n * cfg.top_k // cfg.n_experts if expert else n
    return total, active


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` (None: the card); a stacked expert leaf is drawn
    one expert matrix at a time (``base.materialize``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return base.materialize(init_specs(cfg), gen, cfg.param_dtype, dev)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None, img_tokens: int = 0):
    """Zero decode cache, one entry per period position "p{j}" with layers
    stacked on its first axis: an attention position's "k", "v" of (G, B,
    S, Hkv, Dh), S = max_len, or min(max_len, sliding_window) slots of a
    ring, with ``kv_quant`` int8 K/V and a float32 "kv_scale" (G, B, S,
    Hkv, 2); a cross-attention position's "k", "v" of (G, B, T, Hkv, Dh),
    T = ``img_tokens`` or ``cfg.n_img_tokens``; an rwkv position's
    "shift_tm" (G, B, D), "wkv" (G, B, H, N, N) and "shift_cm" (G, B, D); a
    mamba position's "conv" (G, B, d_conv - 1, d_inner) and "ssm" (G, B,
    d_inner, d_state). States are in the compute dtype."""
    check_family(cfg)
    dev = resolve_device(device)
    g, dt = cfg.n_groups, cfg.compute_dtype
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    cache = {}
    for j in range(cfg.period):
        mixer = cfg.layer_kind(j)["mixer"]
        if mixer == "rwkv":
            n = cfg.rwkv_head_dim
            c = {"shift_tm": zeros(g, batch, cfg.d_model),
                 "wkv": zeros(g, batch, cfg.d_model // n, n, n),
                 "shift_cm": zeros(g, batch, cfg.d_model)}
        elif mixer == "mamba":
            c = {"conv": zeros(g, batch, cfg.d_conv - 1, cfg.d_inner),
                 "ssm": zeros(g, batch, cfg.d_inner, cfg.d_state)}
        elif mixer == "cross":
            t = img_tokens or cfg.n_img_tokens
            c = {"k": zeros(g, batch, t, cfg.n_kv_heads, cfg.hd),
                 "v": zeros(g, batch, t, cfg.n_kv_heads, cfg.hd)}
        else:
            s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
            shape = (g, batch, s, cfg.n_kv_heads, cfg.hd)
            kv_dt = torch.int8 if cfg.kv_quant else dt
            c = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
                 "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
            if cfg.kv_quant:
                c["kv_scale"] = torch.zeros(shape[:-1] + (2,), dtype=torch.float32, device=dev)
        cache[f"p{j}"] = c
    return cache


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


def _ffn(x, p, cfg):
    h2 = layers.apply_norm(x, p["ln2"], cfg.norm_type)
    if "moe" in p:  # decode (S == 1) routes the batch as one group, else each row
        return x + moe.moe_ffn(h2, p["moe"], cfg)
    return x + layers.mlp(h2, p["mlp"], cfg)


def _attn_block(x, p, cfg, *, cache, g, pos0, kv_len, rope, prefill):
    h = layers.apply_norm(x, p["ln1"], cfg.norm_type)
    q, k, v = layers.qkv_proj(h, p["attn"], cfg, rope)
    out = _attention(q, k, v, cfg, cache=cache, g=g, pos0=pos0, kv_len=kv_len, prefill=prefill)
    return _ffn(x + layers.out_proj(out, p["attn"]), p, cfg)


def cross_attention(q, k, v):
    """Non-causal attention of q (B, S, H, Dh) over all T image keys of
    the cross cache k, v (B, T, Hkv, Dh): ``layers.chunk_attention`` with
    the queries at cache positions T - 1, T, ..., so each sees every key. A
    query row then sums over the same tree of pow2_ceil(T) keys in a
    prefill as in a decode step, whatever the batch."""
    pos0 = torch.full((q.shape[0],), k.shape[1] - 1, dtype=torch.int64, device=q.device)
    return layers.chunk_attention(q, k, v, pos0)


def _cross_block(x, p, cfg, *, cache, g, img, prefill):
    """Gated cross-attention over the image tokens, as the reference's
    ``_attn_block(cross=True)``: q from the text alone (no RoPE), the
    image's K/V projected and stored at a prefill and read from the cache
    at a decode step, then out_proj * tanh(gate_attn) and mlp * tanh(gate_ffn)."""
    a = p["attn"]
    h = layers.apply_norm(x, p["ln1"], cfg.norm_type)
    q = _cross_q(h, a, cfg)
    ck, cv = cache["k"][g], cache["v"][g]
    if prefill:
        k, v = _cross_kv(img.to(x.dtype), a, cfg)
        ck.copy_(k)
        cv.copy_(v)
    out = cross_attention(q, ck, cv)
    x = x + layers.out_proj(out, a) * torch.tanh(p["gate_attn"])
    h2 = layers.apply_norm(x, p["ln2"], cfg.norm_type)
    return x + layers.mlp(h2, p["mlp"], cfg) * torch.tanh(p["gate_ffn"])


def _cross_q(h, a, cfg):
    """The text's queries of a cross-attention layer: no RoPE."""
    b, s, _ = h.shape
    q = layers._linear(h, a["wq"])
    if cfg.qkv_bias:
        q = q + a["bq"]
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, a["q_norm"])
    return q


def _cross_kv(hi, a, cfg):
    """The image's K/V (B, T, Hkv, Dh) of a cross-attention layer."""
    kv_shape = hi.shape[:2] + (cfg.n_kv_heads, cfg.hd)
    k = layers._linear(hi, a["wk"]).reshape(kv_shape)
    v = layers._linear(hi, a["wv"]).reshape(kv_shape)
    if cfg.qk_norm:
        k = layers.rms_norm(k, a["k_norm"])
    return k, v


def _mamba_block(x, p, cfg, *, cache, g, prefill):
    """A prefill starts from a zero state, a decode step from layer g's
    state; both write the state they end in."""
    h = layers.apply_norm(x, p["ln1"], cfg.norm_type)
    state = None if prefill else {"conv": cache["conv"][g], "ssm": cache["ssm"][g]}
    y, new = mamba.mamba_layer(h, p["mamba"], cfg, state)
    cache["conv"][g].copy_(new["conv"])
    cache["ssm"][g].copy_(new["ssm"])
    return _ffn(x + y, p, cfg)


def _rwkv_block(x, p, cfg, *, cache, g, prefill):
    """Time-mix and channel-mix; state as in ``_mamba_block``."""
    h = layers.apply_norm(x, p["ln1"], cfg.norm_type)
    st = None if prefill else {"shift": cache["shift_tm"][g], "wkv": cache["wkv"][g]}
    y, tm = rwkv6.time_mix(h, p["tm"], cfg, st)
    x = x + y
    h2 = layers.apply_norm(x, p["ln2"], cfg.norm_type)
    y2, cm = rwkv6.channel_mix(h2, p["cm"], cfg, None if prefill else
                               {"shift": cache["shift_cm"][g]})
    cache["shift_tm"][g].copy_(tm["shift"])
    cache["wkv"][g].copy_(tm["wkv"])
    cache["shift_cm"][g].copy_(cm["shift"])
    return x + y2


def _sinusoid(s: int, d: int, dtype, device, offset: int = 0):
    """(1, s, d) sinusoidal positions offset .. offset + s - 1: sin then
    cos of pos / 10000^(2i / d), in float32, cast to ``dtype``."""
    pos = (torch.arange(s, dtype=torch.float32, device=device) + offset)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)[None]


def _embed(params, tokens, cfg):
    """(B, S) tokens, or an audio config's (B, K, S): the sum of the K
    codebook embeddings in codebook order plus the positions 0 .. S - 1,
    in the parameter dtype; cast to the compute dtype."""
    if not cfg.n_codebooks:
        return params["embed"][tokens].to(cfg.compute_dtype)
    e = params["embed"]
    x = e[0][tokens[:, 0]]
    for k in range(1, cfg.n_codebooks):
        x = x + e[k][tokens[:, k]]
    x = x + _sinusoid(tokens.shape[-1], cfg.d_model, x.dtype, x.device)
    return x.to(cfg.compute_dtype)


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
    return w.transpose(-1, -2) if cfg.tie_embeddings else w


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


def _check_inputs(params, tokens, cfg: ModelConfig, cache, pos0, prefill: bool, img) -> None:
    """The vlm and audio inputs the reference cannot run, refused with
    ``ValueError`` before any launch."""
    s = tokens.shape[-1]
    chunk = not prefill and s != 1
    if cfg.n_codebooks:
        if tokens.ndim != 3 or tokens.shape[1] != cfg.n_codebooks:
            raise ValueError(f"{cfg.name}: tokens must be (B, {cfg.n_codebooks}, S), got "
                             f"{tuple(tokens.shape)}")
        nd = pos0.ndim if hasattr(pos0, "ndim") else int(isinstance(pos0, (list, tuple)))
        if nd:
            raise ValueError(f"{cfg.name}: a codebook decoder takes one scalar position (the "
                             "reference's sinusoid cannot take a per-lane vector)")
        if chunk:
            raise ValueError(f"{cfg.name}: a codebook decoder takes prefills and one-token "
                             "decode steps, not chunks")
    if cfg.family != "vlm":
        return
    if chunk:
        raise ValueError(f"{cfg.name}: a vlm takes prefills and one-token decode steps, not "
                         "chunks (the reference's chunk mode passes no image)")
    for j in range(cfg.period):
        if cfg.layer_kind(j)["mixer"] != "cross":
            continue
        for w in ("wk", "wv"):
            if isinstance(params["blocks"][f"p{j}"]["attn"][w], kops.EccWeight):
                raise ValueError(f"{cfg.name}: blocks.p{j}.attn.{w} is ECC-protected; the "
                                 "reference projects the image with a plain einsum, which "
                                 "cannot read an EccWeight")
        if not prefill:
            continue
        t = cache[f"p{j}"]["k"].shape[2]
        if img is None:
            raise ValueError(f"{cfg.name}: a vlm prefill needs the image embeddings (img=)")
        if tuple(img.shape) != (tokens.shape[0], t, cfg.d_model):
            raise ValueError(f"{cfg.name}: img must be (B, T, D) = ({tokens.shape[0]}, {t}, "
                             f"{cfg.d_model}) for this cache, got {tuple(img.shape)}")


def forward(params, tokens, cfg: ModelConfig, cache, pos0, kv_len: int | None = None,
            prefill: bool = False, img=None):
    """Backbone: (B, S) tokens, an audio config's (B, K, S), at cache
    positions pos0 .. pos0 + S - 1 (pos0 a scalar or (B,); an audio
    config's a scalar) -> final-norm hidden (B, S, D); writes their K/V and
    the recurrent layers' states into the cache in place. A vlm prefill
    projects ``img`` (B, T, D) into each cross-attention layer's cache. ``kv_len`` bounds
    max(pos0) + S from the host (derived when the positions are on the
    host; else the cache length). ``prefill`` (pos0 0) marks a prompt,
    which a ring or int8 cache stores after attending it and a recurrent
    layer scans from a zero state; a recurrent layer's other forward is a
    one-token decode step from its state (a chunk is refused: the state
    holds no positions to resume from). Groups run in order, and inside
    each the period positions p0, p1, ... An MoE layer routes a one-token
    forward's batch as one dispatch group and each row of a longer one as
    its own. An audio decode step swaps the offset-0 sinusoid of its
    embedding for the one at its position."""
    check_family(cfg)
    s = tokens.shape[-1]
    if not prefill and s != 1 and recurrent(cfg):
        raise ValueError(f"{cfg.name}: a recurrent mixer takes prefills and one-token "
                         "decode steps, not chunks")
    _check_inputs(params, tokens, cfg, cache, pos0, prefill, img)
    if kv_len is None:
        kv_len = _kv_bound(pos0, s)
    x = _embed(params, tokens, cfg)
    if cfg.n_codebooks and not prefill:
        off = int(pos0)
        x = (x - _sinusoid(1, cfg.d_model, x.dtype, x.device)
             + _sinusoid(1, cfg.d_model, x.dtype, x.device, offset=off))
    pos0 = _positions(pos0, tokens.shape[0], tokens.device)
    kinds = [cfg.layer_kind(j)["mixer"] for j in range(cfg.period)]
    rope = None
    if "attn" in kinds:  # once for every layer
        positions = pos0[:, None] + torch.arange(s, device=x.device)[None, :]
        rope = layers.rope_tables(positions, cfg.hd, cfg.rope_theta)
    for g in range(cfg.n_groups):
        for j, mixer in enumerate(kinds):
            p, c = _layer(params["blocks"][f"p{j}"], g), cache[f"p{j}"]
            if mixer == "attn":
                x = _attn_block(x, p, cfg, cache=c, g=g, pos0=pos0, kv_len=kv_len, rope=rope,
                                prefill=prefill)
            elif mixer == "cross":
                x = _cross_block(x, p, cfg, cache=c, g=g, img=img, prefill=prefill)
            elif mixer == "mamba":
                x = _mamba_block(x, p, cfg, cache=c, g=g, prefill=prefill)
            else:
                x = _rwkv_block(x, p, cfg, cache=c, g=g, prefill=prefill)
    return layers.apply_norm(x, params["final_norm"], cfg.norm_type)


def _logits(params, hidden, cfg):
    """(..., D) hidden -> (..., V) float32 logits, an audio config's (...,
    K, V), one head per codebook. The rows are zero-padded to a multiple of
    ``LOGIT_ROWS`` and every product is LOGIT_ROWS x D by D x V, one shape
    for every call."""
    un = _unembed_f32(params, cfg)
    if cfg.n_codebooks:
        return torch.stack([_rows_times(hidden, un[k]) for k in range(cfg.n_codebooks)], -2)
    return _rows_times(hidden, un)


def _rows_times(hidden, un):
    n, d = hidden.shape[:-1].numel(), hidden.shape[-1]
    h2 = hidden.new_zeros((-(-n // LOGIT_ROWS) * LOGIT_ROWS, d), dtype=torch.float32)
    h2[:n] = hidden.reshape(n, d)
    out = torch.cat([h2[i : i + LOGIT_ROWS] @ un for i in range(0, h2.shape[0], LOGIT_ROWS)])
    return out[:n].reshape(*hidden.shape[:-1], un.shape[1])


@torch.no_grad()
def prefill(params, tokens, cfg: ModelConfig, cache, img=None):
    """Process a prompt, fill the cache (a vlm's cross-attention K/V from
    ``img`` (B, T, D)). Returns (last-token logits, cache)."""
    hidden = forward(params, tokens, cfg, cache, 0, prefill=True, img=img)
    return _logits(params, hidden[:, -1], cfg), cache


@torch.no_grad()
def decode_step(params, tokens, cfg: ModelConfig, cache, pos, kv_len: int | None = None,
                img=None):
    """One decode step of (B, 1) tokens, an audio config's (B, K, 1), at
    0-based position ``pos``: a scalar, or a (B,) vector giving every lane
    its own position (continuous batching; not for audio). A vlm reads its
    image K/V from the cache; ``img`` is unused, as in the reference."""
    hidden = forward(params, tokens, cfg, cache, pos, kv_len)
    return _logits(params, hidden[:, -1], cfg), cache


def _refuse_codebooks(cfg: ModelConfig, entry: str) -> None:
    if cfg.n_codebooks:
        raise ValueError(f"{cfg.name}: {entry} takes single-codebook models (the reference "
                         "asserts it, or its decode loop changes shape)")


def _check_chunkable(cfg: ModelConfig) -> None:
    _refuse_codebooks(cfg, "chunked prefill")
    if cfg.family == "vlm":
        raise ValueError(f"{cfg.name}: chunks need no image (the reference's chunk mode "
                         "passes none to the cross-attention layers)")
    if cfg.sliding_window or cfg.kv_quant:
        raise ValueError(f"{cfg.name}: chunks need a position-indexed float cache "
                         "(no sliding_window, no kv_quant)")
    if recurrent(cfg):
        # the reference's chunk mode restarts the recurrence from a zero
        # state and leaves it unwritten; the port refuses instead
        raise ValueError(f"{cfg.name}: chunks need attention at every layer (a recurrent "
                         "mixer's state cannot resume at a chunk's position)")


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
def sequence_logits(params, tokens, cfg: ModelConfig, img=None):
    """Teacher-forced (B, S, V) float32 logits of a fixed token sequence
    (B, S): the paired clean-against-faulty evaluation of core/campaign.py,
    which feeds the same tokens through both parameter sets. The forward is
    the one of every other entry point, on a fresh cache of S positions, so
    protected leaves read through the fused ECC matmul as in serving and the
    last position's logits equal ``prefill``'s on the same tokens bit for
    bit. As the reference's train-mode forward, it is windowed and
    unquantised: a prefill attends its fresh K/V. A vlm attends ``img``."""
    _refuse_codebooks(cfg, "sequence_logits")
    cache = init_cache(cfg, tokens.shape[0], tokens.shape[1], device=tokens.device,
                       img_tokens=0 if img is None else img.shape[1])
    hidden = forward(params, tokens, cfg, cache, 0, prefill=True, img=img)
    return _logits(params, hidden, cfg)


@torch.no_grad()
def greedy_decode_loop(params, tok0, cfg: ModelConfig, cache, start_pos: int, n_steps: int):
    """Greedy-decode ``n_steps`` tokens after ``tok0`` (B, 1).
    Returns (tokens (B, n_steps) int64, cache)."""
    _refuse_codebooks(cfg, "greedy_decode_loop")
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


# ---------------------------------------------------------------------------
# Training: a cacheless forward with autograd, and the chunked loss
# ---------------------------------------------------------------------------
# Remat per layer group, as the reference's jax.checkpoint policies: None
# keeps every activation, "full" keeps only each group's input, "dots" also
# keeps the outputs of the projections (products with a batch of one:
# jax's dots_with_no_batch_dims_saveable).
REMAT_POLICIES = (None, "full", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat):
    """``fn`` run under the remat policy ``remat``."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {remat!r}")
    if remat is None:
        return fn
    import functools

    from torch.utils import checkpoint as ckpt

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _dots_policy)
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False, **kw)


def _train_attention(q, k, v, cfg):
    """The reference's train-mode choice: a sliding window shorter than the
    sequence takes the band, 4,096 tokens or more the flash form, else the
    direct product (with the window as a mask)."""
    s, w = q.shape[1], cfg.sliding_window
    if w and s > w:
        return layers.banded_attention(q, k, v, window=w, q_chunk=cfg.flash_chunk)
    if s >= 4096:
        return layers.flash_attention(q, k, v, causal=True, q_chunk=cfg.flash_chunk,
                                      kv_chunk=cfg.flash_chunk)
    return layers.full_attention(q, k, v, causal=True, window=w)


def _train_ffn(x, p, cfg):
    """x + the feed-forward of the ln2-normed x, and the MoE's aux loss
    (0.0 for a dense MLP)."""
    h2 = layers.apply_norm(x, p["ln2"], cfg.norm_type)
    if "moe" in p:
        y, aux = moe.moe_ffn(h2, p["moe"], cfg, with_aux=True)
        return x + y, aux
    return x + layers.mlp(h2, p["mlp"], cfg), 0.0


def _train_layer(x, p, cfg, mixer, rope, img):
    """One layer of the train forward -> (x, aux)."""
    h = layers.apply_norm(x, p["ln1"], cfg.norm_type)
    if mixer == "attn":
        q, k, v = layers.qkv_proj(h, p["attn"], cfg, rope)
        return _train_ffn(x + layers.out_proj(_train_attention(q, k, v, cfg), p["attn"]), p,
                          cfg)
    if mixer == "cross":  # every query sees every image token
        a = p["attn"]
        q = _cross_q(h, a, cfg)
        k, v = _cross_kv(img.to(x.dtype), a, cfg)
        if q.shape[1] >= 2048:
            out = layers.flash_attention(q, k, v, causal=False, q_chunk=cfg.flash_chunk,
                                         kv_chunk=k.shape[1])
        else:
            out = layers.full_attention(q, k, v, causal=False)
        x = x + layers.out_proj(out, a) * torch.tanh(p["gate_attn"])
        h2 = layers.apply_norm(x, p["ln2"], cfg.norm_type)
        return x + layers.mlp(h2, p["mlp"], cfg) * torch.tanh(p["gate_ffn"]), 0.0
    if mixer == "mamba":
        y, _ = mamba.mamba_layer(h, p["mamba"], cfg, None)
        return _train_ffn(x + y, p, cfg)
    y, _ = rwkv6.time_mix(h, p["tm"], cfg, None)
    x = x + y
    h2 = layers.apply_norm(x, p["ln2"], cfg.norm_type)
    y2, _ = rwkv6.channel_mix(h2, p["cm"], cfg, None)
    return x + y2, 0.0


def _train_embed(params, tokens, cfg):
    """``_embed`` through ``F.embedding``: the same gather, whose gradient
    on the card is a sorted segment sum rather than an atomic scatter."""
    e = params["embed"]
    if not cfg.n_codebooks:
        return F.embedding(tokens, e).to(cfg.compute_dtype)
    x = F.embedding(tokens[:, 0], e[0])
    for k in range(1, cfg.n_codebooks):
        x = x + F.embedding(tokens[:, k], e[k])
    x = x + _sinusoid(tokens.shape[-1], cfg.d_model, x.dtype, x.device)
    return x.to(cfg.compute_dtype)


def _unstack(tree, n: int) -> list:
    """A stacked parameter subtree as ``n`` per-layer trees (views whose
    gradients autograd stacks back in one operation)."""
    flat = base.flatten(tree)
    per = [torch.unbind(leaf, 0) for _, leaf in flat]
    return [base.unflatten(tree, [u[g] for u in per]) for g in range(n)]


def train_forward(params, tokens, cfg: ModelConfig, img=None, remat=None):
    """The reference's ``forward(mode="train")``: no cache, gradients kept.
    (B, S) tokens, an audio config's (B, K, S), at positions 0 .. S - 1 ->
    (final-norm hidden (B, S, D), float32 aux loss: the MoE layers'
    load-balancing losses summed). A vlm attends ``img`` (B, T, D) without
    a causal mask. Groups run in order, each under ``remat``."""
    check_family(cfg)
    kinds = [cfg.layer_kind(j)["mixer"] for j in range(cfg.period)]
    if "cross" in kinds and img is None:
        raise ValueError(f"{cfg.name}: a vlm train forward needs the image embeddings (img=)")
    tokens = tokens.long()
    s = tokens.shape[-1]
    x = _train_embed(params, tokens, cfg)
    rope = None
    if "attn" in kinds:
        rope = layers.rope_tables(torch.arange(s, device=x.device)[None, :], cfg.hd,
                                  cfg.rope_theta)
    groups = {j: _unstack(params["blocks"][f"p{j}"], cfg.n_groups) for j in range(cfg.period)}

    def group(h, g):
        aux_g = 0.0
        for j, mixer in enumerate(kinds):
            h, a = _train_layer(h, groups[j][g], cfg, mixer, rope, img)
            aux_g = aux_g + a
        return h, torch.as_tensor(aux_g, dtype=torch.float32, device=h.device)

    step = _remat(group, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.n_groups):
        x, a = step(x, g)
        aux = aux + a
    return layers.apply_norm(x, params["final_norm"], cfg.norm_type), aux


def chunked_xent(hidden, unembed, labels, chunk: int = 512):
    """Mean cross-entropy without the (B, S, V) logits: hidden (B, S, D),
    unembed (D, V), labels (B, S) (-1 = masked). The sequence is cut into
    chunks (``chunk``, halved until it divides S) whose (B, chunk, V)
    logits are float32 products."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    labels = labels.long()
    un = unembed.to(torch.float32)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        h, lab = hidden[:, c0:c0 + chunk].to(torch.float32), labels[:, c0:c0 + chunk]
        logits = torch.einsum("bcd,dv->bcv", h, un)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(lab, min=0)[..., None])[..., 0]
        mask = (lab >= 0).to(torch.float32)
        loss_sum = loss_sum + torch.sum((lse - gold) * mask)
        n = n + mask.sum()
    return loss_sum / torch.clamp(n, min=1.0)


def train_loss(params, batch, cfg: ModelConfig, remat="full"):
    """batch: {"tokens", "labels"[, "img"]} tensors. Returns (loss = ce +
    0.01 x aux, {"ce", "aux"}); an audio config's ce is the mean of one
    loss per codebook."""
    hidden, aux = train_forward(params, batch["tokens"], cfg, img=batch.get("img"), remat=remat)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    un = w.transpose(-1, -2) if cfg.tie_embeddings else w
    labels = batch["labels"]
    if cfg.n_codebooks:
        ce = sum(chunked_xent(hidden, un[k], labels[:, k]) for k in range(cfg.n_codebooks))
        ce = ce / cfg.n_codebooks
    else:
        ce = chunked_xent(hidden, un, labels)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}
