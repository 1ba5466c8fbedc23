"""Selective SSM (Mamba-1) layer of the Jamba hybrid.

A sequence longer than one token runs the reference's chunked lowering:
chunks of ``lc`` steps (``rwkv6.chunks_of``), a zero-state scan inside every
chunk (all chunks at once, a Python loop over the lc steps on (B, nc,
d_inner, d_state) tensors), a loop over the chunks that carries the state
across their boundaries, and a closed-form correction that adds each
chunk's entering state:

    h_t = P_{1..t} * h_start + h0_t          (P = cumprod of the decays)
    y_t = C_t . h_t = y0_t + C_t . (P_t * h_start)

A one-token step is the recurrence itself. The state runs in the compute
dtype; A = -exp(a_log) is taken in float32 and cast, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import model_bounds
from repro_torch.models.layers import _linear
from repro_torch.models.rwkv6 import chunks_of


def _conv_causal(x, w, b):
    """Depthwise causal convolution, the taps added in order. x: (B, S,
    di); w: (di, K); b: (di,)."""
    k = w.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i : i + x.shape[1], :] * w[:, i]
    return out + b


def _ssm_scan_chunked(decay, inp, c_coef, h0):
    """decay / inp: (B, S, di, ds); c_coef: (B, S, ds); h0: (B, di, ds).
    Returns (y (B, S, di), final state (B, di, ds))."""
    b, s, di, ds = decay.shape
    nc, lc = chunks_of(s)
    dc = decay.reshape(b, nc, lc, di, ds)
    ic = inp.reshape(b, nc, lc, di, ds)
    cc = c_coef.reshape(b, nc, lc, ds)

    h = decay.new_zeros((b, nc, di, ds))
    hs = []
    for t in range(lc):  # within every chunk from a zero state
        h = dc[:, :, t] * h + ic[:, :, t]
        hs.append(h)
    y0 = torch.einsum("bcldk,bclk->bcld", torch.stack(hs, dim=2), cc)
    del hs

    p_cum = torch.cumprod(dc, dim=2)  # (B, nc, lc, di, ds)
    p_full = p_cum[:, :, -1]
    starts, st = [], h0
    for c in range(nc):  # the state entering each chunk
        starts.append(st)
        st = p_full[:, c] * st + h[:, c]
    h_starts = torch.stack(starts, dim=1)  # (B, nc, di, ds)
    y_corr = torch.einsum("bcldk,bclk->bcld", p_cum * h_starts[:, :, None], cc)
    return (y0 + y_corr).reshape(b, s, di), st


def mamba_layer(x, p, cfg, state=None):
    """x: (B, S, D). state: None (a fresh sequence) or {"conv": (B,
    d_conv - 1, di), "ssm": (B, di, ds)}. Returns (out (B, S, D), new
    state); a fresh sequence shorter than d_conv - 1 left-pads its conv
    state with zeros."""
    b, s, _ = x.shape
    di, kc = cfg.d_inner, cfg.d_conv
    xs, z = torch.split(_linear(x, p["in_proj"]), di, dim=-1)  # (B, S, di) each

    if state is not None:
        conv_in = torch.cat([state["conv"], xs], dim=1)
        new_conv = conv_in[:, -(kc - 1):, :]
        xs_c = _conv_causal(conv_in, p["conv_w"], p["conv_b"])[:, kc - 1:, :]
    else:
        pad = max(0, (kc - 1) - s)
        new_conv = F.pad(xs, (0, 0, pad, 0))[:, -(kc - 1):, :]
        xs_c = _conv_causal(xs, p["conv_w"], p["conv_b"])
    xs_c = F.silu(xs_c)
    out, h_fin = _ssm(xs_c, z, _linear(xs_c, p["x_proj"]), p, cfg,
                      None if state is None else state["ssm"])
    return out, {"conv": new_conv, "ssm": h_fin}


def _ssm(xs_c, z, dbc, p, cfg, h0=None):
    """The selective scan of the conv output ``xs_c`` (B, S, di) on the
    channels of ``p``'s ``dt_bias`` (all of them, or a model rank's), from
    ``dbc``, ``x_proj``'s whole product: delta, B and C, the scan from the
    state ``h0`` (None: zeros), the skip, the ``z`` gate and the output
    projection (a partial sum over the channels on a model rank). Returns
    (out, final state)."""
    b, s, di = xs_c.shape
    ds = cfg.d_state
    dt_rank = p["dt_proj"].shape[0]
    delta, bmat, cmat = torch.split(dbc, [dt_rank, ds, ds], dim=-1)
    delta = F.softplus(_linear(delta, p["dt_proj"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"].to(torch.float32)).to(xs_c.dtype)  # (di, ds)

    decay = torch.exp(delta[..., None] * a)  # (B, S, di, ds)
    inp = (delta * xs_c)[..., None] * bmat[:, :, None, :]

    if h0 is None:
        h0 = xs_c.new_zeros((b, di, ds))
    if s == 1:  # a decode step: the recurrence itself
        h_fin = decay[:, 0] * h0 + inp[:, 0]
        y = torch.einsum("bdk,bk->bd", h_fin, cmat[:, 0])[:, None, :]
    else:
        y, h_fin = _ssm_scan_chunked(decay, inp, cmat, h0)

    y = y + xs_c * p["d_skip"]
    return _linear(y * F.silu(z), p["out_proj"]), h_fin


def mamba_layer_sharded(x, ps, cfg, model):
    """``mamba_layer`` of a fresh sequence on the "model" axis ``model``
    (``collectives.ModelAxis``), ``ps`` one local tree a branch. The rules
    cut ``in_proj``'s 2 d_inner columns into contiguous blocks, so a rank's
    block is not its d_inner channels' xs and z (at two ranks rank 0 holds
    all of xs): the branches' products are gathered whole (activations,
    never the weight) and enter the region again, where each branch takes
    its channels' xs and z. ``conv_*``, ``dt_proj``'s columns, ``dt_bias``,
    ``a_log`` and ``d_skip`` are its channels; ``x_proj`` is row-parallel,
    so its partial products leave summed, before delta, B and C are split,
    and enter again; ``out_proj`` is row-parallel. Where the rule leaves
    ``in_proj`` or the channels whole, that part is computed whole."""
    di, p0 = cfg.d_inner, ps[0]
    if p0["in_proj"].shape[-1] == 2 * di:
        return mamba_layer(x, p0, cfg)[0]
    xz = model.gather([_linear(t, p["in_proj"]) for t, p in zip(model.enter(x), ps)], -1)
    conv = lambda t, p: F.silu(_conv_causal(t, p["conv_w"], p["conv_b"]))
    di_loc = p0["conv_b"].shape[-1]
    if di_loc == di:
        xs_c = conv(xz[..., :di], p0)
        return _ssm(xs_c, xz[..., di:], _linear(xs_c, p0["x_proj"]), p0, cfg)[0]
    branch = []
    for r, t, p in zip(model.ranks, model.enter(xz), ps):
        c0, c1 = model_bounds(di_loc, r)
        branch.append((conv(t[..., c0:c1], p), t[..., di + c0:di + c1]))
    dbc = model.leave([_linear(xs_c, p["x_proj"]) for (xs_c, _), p in zip(branch, ps)])
    return model.leave([_ssm(xs_c, z, d, p, cfg)[0]
                        for (xs_c, z), d, p in zip(branch, model.enter(dbc), ps)])
