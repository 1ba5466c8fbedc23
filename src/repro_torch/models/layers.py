"""Transformer layers: norms, RoPE, GQA attention, projections, MLPs.

Attention stays plain PyTorch, as the reference computes it outside its
kernels. Protected weights (``EccWeight``) go through the fused ECC read
path ``ops.ecc_matmul``.

Every sum over a feature or cache axis (the norms, the attention products,
the softmax denominator) is a pairwise tree of elementwise adds
(``tree_sum``), so a row's result depends on that row alone and never on
how many rows the call holds: PyTorch's reductions and cuBLAS choose their
split of a sum by the tensor's shape. With one attention path for prefill,
chunks and decode (``chunk_attention`` over the cache), a token's logits are
then the same floats whether it is decoded alone, in a batch, in a chunk, or
in a prefill, which paged serving with shared prefixes and speculative
verification rely on for exact greedy tokens. The attention's products are
walked in bounded blocks over only the keys a block attends, and its sums
over keys are power-of-two trees, which zero keys past a row's end do not
change.
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


def tree_sum(x, dim: int = -1):
    """Sum over ``dim`` by pairwise halving, element i with element i + n/2
    (an odd tail element is carried to the next level). The order of the
    adds depends only on the length of ``dim``. An even level is a sum over
    an axis of two, one add per element that no reduction order can change
    (up to the sign of a zero sum), in one operation instead of two slices
    and an add."""
    dim = dim % x.ndim
    n = x.shape[dim]
    while n > 1:
        h = n // 2
        if n % 2:
            y = torch.cat([x.narrow(dim, 0, h) + x.narrow(dim, h, h), x.narrow(dim, 2 * h, 1)],
                          dim=dim)
        else:
            y = x.unflatten(dim, (2, h)).sum(dim)
        x, n = y, y.shape[dim]
    return x.squeeze(dim)


def rms_norm(x, gamma, eps=1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    ms = tree_sum(x32 * x32, -1)[..., None] / x32.shape[-1]
    inv = torch.rsqrt(ms + eps)
    return (x32 * inv).to(dt) * gamma


def layer_norm(x, gamma, beta, eps=1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    d = x32.shape[-1]
    xc = x32 - tree_sum(x32, -1)[..., None] / d
    var = tree_sum(xc * xc, -1)[..., None] / d
    return (xc * torch.rsqrt(var + eps)).to(dt) * gamma + beta


def apply_norm(x, p, norm_type):
    if norm_type == "layernorm":
        return layer_norm(x, p["gamma"], p["beta"])
    return rms_norm(x, p["gamma"])


def rope_freqs(hd, theta, device):
    # A Python-scalar base: a tensor built from ``theta`` on the card would
    # be a host-to-device copy that synchronises the stream every layer.
    exps = -torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return torch.pow(float(theta), exps)


def rope_tables(positions, hd, theta):
    """(cos, sin) float32 of positions (B, S) or (S,), shaped to broadcast
    against (B, S, H, Dh / 2)."""
    inv = rope_freqs(hd, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x, cos, sin):
    """RoPE of x (B, S, H, Dh) with ``rope_tables``."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)



# float32 elements of the largest product tensor one attention block forms:
# the query rows are walked in blocks of this size, so memory stays bounded
# at any prompt length.
ATTN_BLOCK_ELEMS = 1 << 27


def pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def tree_sum_products(a, b, dim: int = -1, exact: bool = False):
    """``tree_sum(a * b, dim)`` for broadcastable a and b that both span
    ``dim``. With ``exact`` (every product a float32 holds exactly, as
    products of bf16 or fp16 values do), the first halving level is fused
    into one ``addcmul`` so the full product is never formed; the sums are
    the same floats. Without it an ``addcmul`` may round its product or not
    by the element's place in memory (a fused multiply-add on one path, not
    on another), so the product is formed first."""
    dim = dim % max(a.ndim, b.ndim)
    n = a.shape[dim]
    if n % 2 or not exact:
        return tree_sum(a * b, dim)
    h = n // 2
    t = a.narrow(dim, 0, h) * b.narrow(dim, 0, h)
    t.addcmul_(a.narrow(dim, h, h), b.narrow(dim, h, h))
    return tree_sum(t, dim)


def softmax(s):
    """Softmax over the last axis with a tree-summed denominator."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / tree_sum(e, -1)[..., None]


def _attend(qg, k_cache, v_cache, qpos, n_keys: int, dtype, window: int = 0):
    """One block of query rows against the cache's first keys.

    qg: (B, Hkv, R, Q, Dh) float32; caches (B, S, Hkv, Dh) with S <= n_keys,
    a power of two; qpos: (B, Q) cache positions of the rows, each attending
    keys qpos - window < kpos <= qpos (``window`` 0: every earlier key). The
    key axis is zero-padded to n_keys for the softmax denominator and the PV
    sum."""
    s_len, dh = k_cache.shape[1], qg.shape[-1]
    exact = dtype.itemsize <= 2
    kt = k_cache.permute(0, 2, 1, 3).to(torch.float32)[:, :, None, None]  # (B, Hkv, 1, 1, S, Dh)
    s = tree_sum_products(qg[..., None, :], kt, -1, exact)  # (B, Hkv, R, Q, S)
    s = s.to(dtype).to(torch.float32) / math.sqrt(dh)
    kpos = torch.arange(s_len, device=qg.device)
    valid = kpos <= qpos[..., None]
    if window:
        valid = valid & (kpos > qpos[..., None] - window)
    valid = valid[:, None, None]  # (B, 1, 1, Q, S)
    s = torch.where(valid, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    vt = v_cache.permute(0, 2, 1, 3).to(torch.float32)  # (B, Hkv, S, Dh)
    if n_keys > s_len:
        e = F.pad(e, (0, n_keys - s_len))
        vt = F.pad(vt, (0, 0, 0, n_keys - s_len))
    p = (e / tree_sum(e, -1)[..., None]).to(dtype).to(torch.float32)
    out = tree_sum_products(p[..., None], vt[:, :, None, None], -2, exact)  # (B, Hkv, R, Q, Dh)
    return out.to(dtype)


def chunk_attention(q, k_cache, v_cache, pos0, kv_len: int | None = None, window: int = 0):
    """Multi-token attention against a KV cache: the one attention path of
    prefill (``pos0`` = 0), chunked prefill, speculative verification and
    decode (one token).

    q: (B, Sq, H, Dh), Sq new tokens whose K/V are already in the cache;
    caches (B, S_max, Hkv, Dh); pos0: (B,) cache position of each lane's
    first new token. Token i attends cache positions <= pos0 + i, and with
    a sliding ``window`` only those above pos0 + i - window (masked keys
    enter the sums as exact zeros). ``kv_len``, a host-side bound on
    max(pos0) + Sq (None: S_max + Sq), limits the keys read.

    Products are formed in float32 (exact for bf16 inputs) and tree-summed;
    scores and outputs are rounded to q's dtype where the reference's
    einsums round. Every sum over keys is a tree over a power-of-two number
    of keys, zero beyond the row's last position. Such a tree gives the same
    float for any power-of-two length at or above the row's valid keys, so a
    row's output does not depend on ``kv_len``, on Sq, or on the other lanes.
    Under a power-of-two window, the tree's levels above the window's length
    add each position's key to exact zeros, folding position p onto p %
    window: a ring of ``window`` slots gives the same floats. Query rows are walked in blocks of at most ``ATTN_BLOCK_ELEMS`` product
    elements, each block reading only the keys its last row attends."""
    b, sq, h, dh = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    bound = smax + sq if kv_len is None else int(kv_len)
    qg = q.reshape(b, sq, hkv, h // hkv, dh).permute(0, 2, 3, 1, 4).to(torch.float32)
    qpos = pos0.reshape(b, 1) + torch.arange(sq, device=q.device)[None, :]  # (B, Sq)
    n_top = pow2_ceil(max(min(bound, smax), 1))
    # the largest tensor a block forms: the products, halved where fused
    rows = max(1, ATTN_BLOCK_ELEMS // (b * h * n_top * dh // (2 if q.dtype.itemsize <= 2 else 1)))
    outs = []
    for i0 in range(0, sq, rows):
        i1 = min(sq, i0 + rows)
        n_keys = pow2_ceil(max(min(bound - sq + i1, smax), 1))
        s_len = min(n_keys, smax)
        outs.append(_attend(qg[:, :, :, i0:i1], k_cache[:, :s_len], v_cache[:, :s_len],
                            qpos[:, i0:i1], n_keys, q.dtype, window))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def decode_attention(q, k_cache, v_cache, cur_len):
    """One-token attention against a KV cache: q (B, 1, H, Dh), caches
    (B, S_max, Hkv, Dh), ``cur_len`` (B,) valid entries per lane (including
    the token being decoded); ``chunk_attention`` with one token."""
    return chunk_attention(q, k_cache, v_cache, cur_len - 1)


# ---------------------------------------------------------------------------
# Train-mode attention: the reference's three cacheless forms, differentiable
# plain products (batch invariance is a serving property; training does not
# need the tree sums above). Scores are formed in q's dtype and cast to
# float32, probabilities cast back to q's dtype, as the reference's einsums
# round. Query heads are grouped over their KV head (head h = g * R + r,
# the reference's repeat order) instead of repeating K and V.
# ---------------------------------------------------------------------------
def _inv_sqrt(dh: int) -> float:
    """1 / sqrt(dh) rounded as float32 arithmetic rounds it."""
    return torch.tensor(float(dh), dtype=torch.float32).sqrt().reciprocal().item()


def _scores(q, k):
    """q (B, Sq, Hkv, R, Dh), k (B, Sk, Hkv, Dh) -> (B, Hkv, R, Sq, Sk) float32."""
    return torch.einsum("bqgrd,bkgd->bgrqk", q, k).to(torch.float32)


def _pv(p, v):
    """p (B, Hkv, R, Sq, Sk), v (B, Sk, Hkv, Dh) -> (B, Sq, Hkv, R, Dh)."""
    return torch.einsum("bgrqk,bkgd->bqgrd", p, v)


def full_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, Dh), k/v: (B, Skv, Hkv, Dh); query i sits at key
    position i + Skv - Sq and, with ``causal``, attends keys up to it (and
    above it minus ``window``)."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    s = _scores(qg, k) / math.sqrt(dh)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = kpos <= qpos if causal else torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if window:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _pv(p, v).reshape(b, sq, h, dh)


def flash_attention(q, k, v, causal: bool = True, q_chunk: int = 1024, kv_chunk: int = 1024):
    """Doubly chunked online-softmax attention: memory O(q_chunk x
    kv_chunk) a step instead of O(S^2). A causal q chunk skips the KV
    chunks wholly after its last query: there the reference adds exp(-inf)
    = 0 to a sum whose running maximum is already finite (key 0 is valid for
    every query), which leaves every float as it was."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    r = h // hkv
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    assert sq % q_chunk == 0 and skv % kv_chunk == 0, (sq, q_chunk, skv, kv_chunk)
    scale = _inv_sqrt(dh)
    qg = q.reshape(b, sq, hkv, r, dh)
    outs = []
    for qi in range(sq // q_chunk):
        qc = qg[:, qi * q_chunk:(qi + 1) * q_chunk]
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)[:, None] + (skv - sq)
        m = torch.full((b, hkv, r, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, q_chunk, hkv, r, dh), dtype=torch.float32, device=q.device)
        last = (qi + 1) * q_chunk - 1 + (skv - sq)
        for ki in range(skv // kv_chunk):
            if causal and ki * kv_chunk > last:
                break
            kc = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vc = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            s = _scores(qc, kc) * scale
            if causal:
                kpos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)[None, :]
                s = torch.where(kpos <= qpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + _pv(p.to(q.dtype), vc).to(
                torch.float32)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(b, sq, h, dh)


def banded_attention(q, k, v, window: int, q_chunk: int = 1024):
    """Sliding-window causal attention over an explicit KV band: each q
    chunk [t, t + C) reads only keys [t - window, t + C), so the products
    are O(S x (window + C)), not O(S^2)."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    q_chunk = min(q_chunk, sq)
    assert sq % q_chunk == 0, (sq, q_chunk)
    band = window + q_chunk
    kp = F.pad(k, (0, 0, 0, 0, window, 0))  # left-pad the keys by the window
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    scale = _inv_sqrt(dh)
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    qpos = torch.arange(q_chunk, device=q.device)[:, None] + window  # position in the band
    kpos = torch.arange(band, device=q.device)[None, :]
    outs = []
    for qi in range(sq // q_chunk):
        start = qi * q_chunk  # the band begins at start - window
        s = _scores(qg[:, start:start + q_chunk], kp[:, start:start + band]) * scale
        valid = (kpos <= qpos) & (kpos > qpos - window) & (kpos + start >= window)
        p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1).to(q.dtype)
        outs.append(_pv(p, vp[:, start:start + band]))
    return torch.cat(outs, dim=1).reshape(b, sq, h, dh)


def qkv_proj(x, p, cfg, rope=None):
    """x: (B, S, D) -> q (B,S,H,Dh), k/v (B,S,Hkv,Dh); q and k rotated by
    ``rope`` = (cos, sin) where given. With ``cfg.qkv_bias`` the three
    biases are added before the reshape, the norm and the rotation. q and k
    are normed and rotated as one tensor of H + Hkv heads (the same floats,
    half the operations)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    q, k, v = (_linear(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, cfg.hd)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    qk = torch.cat([q, k], dim=2)
    if cfg.qk_norm:
        gamma = torch.cat([p["q_norm"].expand(h, -1), p["k_norm"].expand(cfg.n_kv_heads, -1)])
        qk = rms_norm(qk, gamma)
    if rope is not None:
        qk = rotate(qk, *rope)
    return qk[:, :, :h], qk[:, :, h:], v


def out_proj(attn_out, p):
    b, s = attn_out.shape[:2]
    return _linear(attn_out.reshape(b, s, -1), p["wo"])


# jax.nn.gelu's default is the tanh form; F.gelu's is the exact erf form.
_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu2": lambda x: torch.square(F.relu(x)),  # nemotron/minitron MLP
}


def mlp(x, p, cfg):
    """SwiGLU, w2(silu(x w1) * x w3), or with ``cfg.gated_mlp`` False the
    plain w2(act(x w1))."""
    if cfg.gated_mlp:
        gate = F.silu(_linear(x, p["w1"]))
        up = _linear(x, p["w3"])
        return _linear(gate * up, p["w2"])
    return _linear(_ACTS[cfg.mlp_act](_linear(x, p["w1"])), p["w2"])
