"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time-mix with
data-dependent decay, and the squared-ReLU channel-mix.

Time-mix recurrence per head (N = head dim, state S in R^{NxN}):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T        w_t = exp(-exp(wlog_t))

with token-shift DDLERP inputs and a LoRA-generated per-channel decay
wlog_t. A sequence longer than one token runs the reference's chunked form:
the sequence is cut into ``nc`` chunks of ``lc`` steps, a zero-state scan
runs inside every chunk (all chunks at once, a Python loop over the lc
steps on (B, nc, H, N, N) tensors), a loop over the chunks carries the
state across their boundaries, and a closed-form correction adds each
chunk's entering state: y_t += (r_t * P_{t-1})^T S_start (P the cumulative
product of w inside the chunk). A one-token step is the recurrence itself.
The state and the scans run in the compute dtype; only the decay's
double exponential is taken in float32, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _linear, tree_sum

CHUNK = 64
LORA_MIX = 32
LORA_DECAY = 64
N_MIX = 5  # r, k, v, g, w


def chunks_of(s: int) -> tuple[int, int]:
    """(nc, lc) of a length-``s`` scan: nc = max(1, s // CHUNK) chunks of lc
    = s // nc steps. A length they do not cover exactly (129, 131, ...) is
    refused, where the reference's scan fails its assertion."""
    nc = max(1, s // CHUNK)
    lc = s // nc
    if nc * lc != s:
        raise ValueError(f"a recurrent scan of {s} steps is not {nc} chunks of {lc} "
                         f"(CHUNK = {CHUNK}); use a length of at most {CHUNK} or one "
                         "that a whole number of equal chunks covers")
    return nc, lc


def _token_shift(x, last):
    """x: (B, S, D); last: (B, D) the token before x (zeros at a sequence's
    start)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(x, prev, p):
    """The data-dependent lerp giving the five mixed inputs (r, k, v, g, w)."""
    xx = prev - x
    base = x + xx * p["mu_base"]
    b, s, _ = x.shape
    k5 = torch.tanh(_linear(base, p["mix_a"])).reshape(b, s, N_MIX, LORA_MIX)
    dyn = torch.einsum("bsfr,frd->bsfd", k5, p["mix_b"])  # (B, S, 5, D)
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (p["mu_five"] + dyn)
    return [mixed[:, :, i, :] for i in range(N_MIX)]


def _wkv_chunked(r, k, v, w, u, s0):
    """r/k/v/w: (B, S, H, N); u: (H, N); s0: (B, H, N, N). The exact chunked
    WKV. Returns (y (B, S, H, N), final state)."""
    b, s, h, n = r.shape
    nc, lc = chunks_of(s)
    rs, ks, vs, ws = (t.reshape(b, nc, lc, h, n) for t in (r, k, v, w))
    uk = u[:, :, None]
    state = r.new_zeros((b, nc, h, n, n))
    ys = []
    for t in range(lc):  # within every chunk from a zero state
        r_t, k_t, v_t, w_t = rs[:, :, t], ks[:, :, t], vs[:, :, t], ws[:, :, t]
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B, nc, H, N, N)
        ys.append(torch.einsum("bchi,bchij->bchj", r_t, state + uk * kv))
        state = w_t[..., :, None] * state + kv
    y0 = torch.stack(ys, dim=2)  # (B, nc, lc, H, N)

    p_cum = torch.cumprod(ws, dim=2)  # products of w_1..t inside the chunk
    p_full = p_cum[:, :, -1]
    starts, st = [], s0
    for c in range(nc):  # the state entering each chunk
        starts.append(st)
        st = p_full[:, c][..., :, None] * st + state[:, c]
    s_starts = torch.stack(starts, dim=1)  # (B, nc, H, N, N)

    # y_t reads S_{t-1}: its correction factor is the exclusive product P_{t-1}
    p_excl = torch.cat([torch.ones_like(p_cum[:, :, :1]), p_cum[:, :, :-1]], dim=2)
    y_corr = torch.einsum("bclhi,bchij->bclhj", rs * p_excl, s_starts)
    return (y0 + y_corr).reshape(b, s, h, n), st


def _group_norm(y, gamma, beta, eps=64e-5):
    """Per-head LayerNorm (RWKV's ``ln_x``) in float32. y: (B, S, H, N);
    gamma / beta: (H * N,)."""
    b, s, h, n = y.shape
    y32 = y.to(torch.float32)
    yc = y32 - tree_sum(y32, -1)[..., None] / n
    var = tree_sum(yc * yc, -1)[..., None] / n
    yn = (yc * torch.rsqrt(var + eps)).reshape(b, s, h * n)
    return (yn * gamma + beta).to(y.dtype)


def time_mix(x, p, cfg, state=None):
    """RWKV-6's attention substitute. x: (B, S, D); state None (a fresh
    sequence) or {"shift": (B, D), "wkv": (B, H, N, N)}. Returns (out,
    new state)."""
    b, s, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    shift_in = state["shift"] if state is not None else x.new_zeros((b, d))
    xr, xk, xv, xg, xw = _ddlerp(x, _token_shift(x, shift_in), p)

    r = _linear(xr, p["w_r"]).reshape(b, s, h, n)
    k = _linear(xk, p["w_k"]).reshape(b, s, h, n)
    v = _linear(xv, p["w_v"]).reshape(b, s, h, n)
    g = _linear(xg, p["w_g"])
    wlog = p["w_base"] + _linear(torch.tanh(_linear(xw, p["decay_a"])), p["decay_b"])
    w = torch.exp(-torch.exp(wlog.to(torch.float32))).to(x.dtype).reshape(b, s, h, n)
    u = p["u"].reshape(h, n)

    s0 = state["wkv"] if state is not None else x.new_zeros((b, h, n, n))
    if s == 1:  # a decode step: the recurrence itself
        kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]
        y = torch.einsum("bhi,bhij->bhj", r[:, 0], s0 + u[:, :, None] * kv)[:, None]
        s_fin = w[:, 0, :, :, None] * s0 + kv
    else:
        y, s_fin = _wkv_chunked(r, k, v, w, u, s0)

    y = _group_norm(y, p["ln_x_g"], p["ln_x_b"])
    out = _linear(y * F.silu(g), p["w_o"])
    return out, {"shift": x[:, -1, :], "wkv": s_fin}


def channel_mix(x, p, cfg, state=None):
    """RWKV-6's feed-forward: squared ReLU with a token shift. state None or
    {"shift": (B, D)}."""
    b, s, d = x.shape
    shift_in = state["shift"] if state is not None else x.new_zeros((b, d))
    xx = _token_shift(x, shift_in) - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    kv = _linear(torch.square(F.relu(_linear(xk, p["w_k"]))), p["w_v"])
    out = torch.sigmoid(_linear(xr, p["w_r"])) * kv
    return out, {"shift": x[:, -1, :]}
