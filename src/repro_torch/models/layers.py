"""Transformer layers: norms, RoPE, GQA attention, projections, MLP.

Attention stays plain PyTorch, as the reference computes it outside its
kernels. Protected weights (``EccWeight``) go through the fused ECC read
path ``ops.ecc_matmul``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

NEG_INF = -1e30


def _linear(x, w):
    """Dense or ECC-protected linear, dispatched on the parameter type."""
    if isinstance(w, kops.EccWeight):
        return kops.ecc_matmul(x, w).to(x.dtype)
    return torch.einsum("...d,df->...f", x, w)


def rms_norm(x, gamma, eps=1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(dt) * gamma


def rope_freqs(hd, theta, device):
    # A Python-scalar base: a tensor built from ``theta`` on the card would
    # be a host-to-device copy that synchronises the stream every layer.
    exps = -torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return torch.pow(float(theta), exps)


def apply_rope(x, positions, theta):
    """x: (B, S, H, Dh); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def full_attention(q, k, v):
    """Causal attention; q: (B, Sq, H, Dh), k/v: (B, Skv, Hkv, Dh)."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) / math.sqrt(dh)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    scores = torch.where((kpos <= qpos)[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def decode_attention(q, k_cache, v_cache, cur_len):
    """One-token attention against a KV cache.

    q: (B, 1, H, Dh); caches (B, S_max, Hkv, Dh); ``cur_len`` valid entries
    (including the token being decoded)."""
    b, _, h, dh = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, 1, hkv, h // hkv, dh)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k_cache).to(torch.float32) / math.sqrt(dh)
    kpos = torch.arange(smax, device=q.device)
    s = torch.where(kpos < cur_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, v_cache)
    return out.reshape(b, 1, h, dh)


def qkv_proj(x, p, cfg):
    """x: (B, S, D) -> q (B,S,H,Dh), k/v (B,S,Hkv,Dh)."""
    b, s, _ = x.shape
    q = _linear(x, p["wq"])
    k = _linear(x, p["wk"])
    v = _linear(x, p["wv"])
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def out_proj(attn_out, p):
    b, s = attn_out.shape[:2]
    return _linear(attn_out.reshape(b, s, -1), p["wo"])


def mlp(x, p):
    """SwiGLU: w2(silu(x w1) * x w3)."""
    gate = F.silu(_linear(x, p["w1"]))
    up = _linear(x, p["w3"])
    return _linear(gate * up, p["w2"])
