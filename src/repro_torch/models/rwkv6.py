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
    b, _, d = x.shape
    shift_in = state["shift"] if state is not None else x.new_zeros((b, d))
    xr, xk, xv, xg, xw = _ddlerp(x, _token_shift(x, shift_in), p)
    hw = torch.tanh(_linear(xw, p["decay_a"]))
    out, s_fin = _heads(xr, xk, xv, xg, hw, p, cfg, None if state is None else state["wkv"])
    return out, {"shift": x[:, -1, :], "wkv": s_fin}


def _heads(xr, xk, xv, xg, hw, p, cfg, s0=None):
    """Time-mix from its five inputs on the heads of ``p``'s ``w_base``
    (all of them, or a model rank's): the projections, the decay from the
    LoRA hidden ``hw``, the WKV recurrence from the state ``s0`` (None:
    zeros), the per-head norm, the gate and the output projection (a partial
    sum over the heads on a model rank). Returns (out, final state)."""
    b, s, _ = xr.shape
    n = cfg.rwkv_head_dim
    h = p["w_base"].shape[-1] // n
    r = _linear(xr, p["w_r"]).reshape(b, s, h, n)
    k = _linear(xk, p["w_k"]).reshape(b, s, h, n)
    v = _linear(xv, p["w_v"]).reshape(b, s, h, n)
    g = _linear(xg, p["w_g"])
    wlog = p["w_base"] + _linear(hw, p["decay_b"])
    w = torch.exp(-torch.exp(wlog.to(torch.float32))).to(xr.dtype).reshape(b, s, h, n)
    u = p["u"].reshape(h, n)

    if s0 is None:
        s0 = xr.new_zeros((b, h, n, n))
    if s == 1:  # a decode step: the recurrence itself
        kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]
        y = torch.einsum("bhi,bhij->bhj", r[:, 0], s0 + u[:, :, None] * kv)[:, None]
        s_fin = w[:, 0, :, :, None] * s0 + kv
    else:
        y, s_fin = _wkv_chunked(r, k, v, w, u, s0)

    y = _group_norm(y, p["ln_x_g"], p["ln_x_b"])
    return _linear(y * F.silu(g), p["w_o"]), s_fin


def time_mix_sharded(x, ps, cfg, model):
    """``time_mix`` of a fresh sequence on the "model" axis ``model``
    (``collectives.ModelAxis``), ``ps`` one local tree a branch: the token
    shift, the five mixes and the decay LoRA's hidden read only replicated
    leaves, so they are computed whole and enter the region; each branch
    runs its heads (``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` and ``decay_b``
    column-parallel, its slices of ``w_base``, ``u`` and the per-head norm,
    its rows of ``w_o``) and the partial outputs leave summed. Where the
    rule leaves the heads whole, time-mix is computed whole."""
    p0 = ps[0]
    if p0["w_r"].shape[-1] == x.shape[-1]:
        return time_mix(x, p0, cfg)[0]
    xr, xk, xv, xg, xw = _ddlerp(x, _token_shift(x, x.new_zeros((x.shape[0], x.shape[-1]))), p0)
    ins = [model.enter(t) for t in (xr, xk, xv, xg, torch.tanh(_linear(xw, p0["decay_a"])))]
    return model.leave([_heads(*[t[i] for t in ins], p, cfg)[0] for i, p in enumerate(ps)])


def _cm_mixes(x, p, shift_in):
    """Channel-mix's token-shifted inputs (xk, xr) of x (B, S, D), the
    token before x ``shift_in`` (B, D)."""
    xx = _token_shift(x, shift_in) - x
    return x + xx * p["mu_k"], x + xx * p["mu_r"]


def channel_mix(x, p, cfg, state=None):
    """RWKV-6's feed-forward: squared ReLU with a token shift. state None or
    {"shift": (B, D)}."""
    b, s, d = x.shape
    shift_in = state["shift"] if state is not None else x.new_zeros((b, d))
    xk, xr = _cm_mixes(x, p, shift_in)
    kv = _linear(torch.square(F.relu(_linear(xk, p["w_k"]))), p["w_v"])
    out = torch.sigmoid(_linear(xr, p["w_r"])) * kv
    return out, {"shift": x[:, -1, :]}


def channel_mix_sharded(x, ps, cfg, model):
    """``channel_mix`` of a fresh sequence on the "model" axis: the mixes
    whole (replicated leaves), ``w_k`` column- and ``w_v`` row-parallel on
    "ffn" (``kv`` whole once the partials leave summed), and the
    receptance gate on each branch's ``w_r`` columns, a slice of the model
    dim D that is gathered whole before it multiplies ``kv`` (so ``kv``'s
    gradient is whole on every rank). Each part sharded or whole as the
    rules place its leaves."""
    p0 = ps[0]
    xk, xr = _cm_mixes(x, p0, x.new_zeros((x.shape[0], x.shape[-1])))
    kv_of = lambda t, p: _linear(torch.square(F.relu(_linear(t, p["w_k"]))), p["w_v"])
    if p0["w_k"].shape[-1] == cfg.d_ff:
        kv = kv_of(xk, p0)
    else:
        kv = model.leave([kv_of(t, p) for t, p in zip(model.enter(xk), ps)])
    if p0["w_r"].shape[-1] == x.shape[-1]:
        return torch.sigmoid(_linear(xr, p0["w_r"])) * kv
    gates = [torch.sigmoid(_linear(t, p["w_r"])) for t, p in zip(model.enter(xr), ps)]
    return model.gather(gates, -1) * kv
