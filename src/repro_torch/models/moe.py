"""Mixture-of-Experts feed-forward with the reference's sort dispatch.

Each dispatch group sorts its token -> expert assignments (a stable
argsort), ranks them within each expert's segment, gathers them into an
(E, C) slot grid, runs every expert's FFN over its C slots and combines the
weighted outputs back per token. Decode (S == 1) routes the whole batch as
one group; any longer forward routes one group per row. Capacity is per
(group, expert), ``C = int(max(1, round(T * k / E * capacity_factor)))``;
assignments ranked past it are dropped, so which tokens drop depends on
what else the group holds, as in the reference.

Ties: the top-k takes the lower expert index among equal probabilities (a
stable descending sort), as ``jax.lax.top_k`` does. No step uses atomics:
the slot grid is a scatter whose only repeated destination is an extra
slot that is cut off, and the combine gathers each token's k slot outputs
by (token, rank) and sums them in slot order in the compute dtype, as the
reference's scatter-add does.

Every product here has plain (unprotected) weights: the float32 router, the
expert FFNs and the shared expert. Each runs over rows zero-padded to a
multiple of ``MOE_ROWS``, one product shape per weight, so a slot's output
does not depend on how many groups or slots the call holds (the forward
stays batch-invariant; see ``lm._logits``). The train forward asks for the
reference's auxiliary load-balancing loss as well (``with_aux``); serving
does not form it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import model_bounds

MOE_ROWS = 16  # rows of every router, expert and shared-expert product


def _rows(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, D) @ (D, F) as products of MOE_ROWS x D by D x F on the rows
    zero-padded to a multiple of MOE_ROWS."""
    n, d = x2.shape
    xp = x2.new_zeros((-(-n // MOE_ROWS) * MOE_ROWS, d))
    xp[:n] = x2
    return torch.cat([xp[i : i + MOE_ROWS] @ w for i in range(0, xp.shape[0], MOE_ROWS)])[:n]


def capacity(t: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert for a group of ``t`` tokens (Python's round, half
    to even, as the reference)."""
    return int(max(1, round(t * top_k / n_experts * capacity_factor)))


def router_logits(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., E) float32 router logits."""
    d = x.shape[-1]
    out = _rows(x.reshape(-1, d).to(torch.float32), router_w.to(torch.float32))
    return out.reshape(*x.shape[:-1], router_w.shape[-1])


def topk_from_logits(logits: torch.Tensor, top_k: int, dtype):
    """Router logits (..., E) -> (expert_idx (..., k) int64, probs (..., k)
    in ``dtype``): softmax, the k largest (lower index first on a tie),
    renormalised in float32 with a 1e-9 floor."""
    probs_full = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs_full, dim=-1, descending=True, stable=True)
    probs, idx = vals[..., :top_k], idx[..., :top_k]
    probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-9)
    return idx, probs.to(dtype)


def route_topk(x, router_w, n_experts: int, top_k: int):
    """x: (..., D). Returns (expert_idx (..., k), probs (..., k), logits)."""
    logits = router_logits(x, router_w)
    assert logits.shape[-1] == n_experts, (logits.shape, n_experts)
    idx, probs = topk_from_logits(logits, top_k, x.dtype)
    return idx, probs, logits


def sort_dispatch(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """(G, T, k) (or (T, k)) expert assignments -> per group (slot_src
    (E*C,), slot_valid (E*C,), kept (T*k,)): the flat assignment each slot
    holds (T*k where it holds none) and whether each assignment got a slot."""
    single = expert_idx.ndim == 2
    idx = expert_idx[None] if single else expert_idx
    g, t, k = idx.shape
    n, slots = t * k, n_experts * capacity
    flat_e = idx.reshape(g, n).to(torch.int64)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(n, device=idx.device) - first
    kept_sorted = rank < capacity
    dest = torch.where(kept_sorted, sorted_e * capacity + torch.clamp(rank, max=capacity - 1),
                       slots)
    # dropped assignments all land on the extra slot, which is cut off
    slot_src = torch.full((g, slots + 1), n, dtype=torch.int64, device=idx.device)
    slot_src.scatter_(1, dest, order)
    slot_src = slot_src[:, :slots]
    kept = torch.zeros((g, n), dtype=torch.bool, device=idx.device).scatter_(1, order, kept_sorted)
    out = slot_src, slot_src < n, kept
    return tuple(o[0] for o in out) if single else out


def _expert_ffn(xe: torch.Tensor, p, cfg) -> torch.Tensor:
    """xe: (G, E, C, D) -> (G, E, C, D) through each expert's SwiGLU, or
    with ``cfg.gated_mlp`` False its gelu (tanh form) MLP whatever
    ``cfg.mlp_act`` says, as the reference."""
    g, e, c, d = xe.shape
    rows = xe.transpose(0, 1).reshape(e, g * c, d)
    outs = []
    for j in range(e):
        if cfg.gated_mlp:
            h = F.silu(_rows(rows[j], p["w1"][j])) * _rows(rows[j], p["w3"][j])
        else:
            h = F.gelu(_rows(rows[j], p["w1"][j]), approximate="tanh")
        outs.append(_rows(h, p["w2"][j]))
    return torch.stack(outs).reshape(e, g, c, d).transpose(0, 1)


def _shared(x2: torch.Tensor, p) -> torch.Tensor:
    """The shared expert's SwiGLU of (n, D) rows (a partial sum on a model
    rank that holds its "ffn" columns and rows)."""
    h = F.silu(_rows(x2, p["shared_w1"])) * _rows(x2, p["shared_w3"])
    return _rows(h, p["shared_w2"])


def moe_ffn(x: torch.Tensor, p, cfg, with_aux: bool = False, model=None):
    """x: (B, S, D) -> (B, S, D). p: router (D, E), w1 / w3 (E, D, F), w2
    (E, F, D), and with ``cfg.shared_expert`` shared_w1 / shared_w3 (D, F),
    shared_w2 (F, D). ``with_aux`` returns (out, load_balance_loss of the
    router logits and the top-1 experts) instead.

    With ``model`` (a ``collectives.ModelAxis``) ``p`` is one local tree a
    branch and the experts run on the "model" axis as the rules place them:
    expert-parallel where the experts divide it (each rank its own experts'
    slots, zeros elsewhere), else tensor-parallel on "ffn" inside every
    expert (the rules' fallback), else whole. Routing stays global: every
    rank routes every token with the replicated router, and the routing
    weights enter the region, so the router's gradient is whole on every
    rank. The partial outputs, and the shared expert's column/row-parallel
    partial, leave the region summed over the axis."""
    b, s, d = x.shape
    ps = [p] if model is None else p
    p0 = ps[0]
    e, k = cfg.n_experts, cfg.top_k
    xg = x.reshape(1, b, d) if s == 1 else x  # decode: one group; else one per row
    g, t = xg.shape[:2]
    cap = capacity(t, k, e, cfg.capacity_factor)

    expert_idx, probs, logits = route_topk(xg, p0["router"], e, k)
    slot_src, slot_valid, _ = sort_dispatch(expert_idx, e, cap)

    tok_of_slot = torch.clamp(slot_src // k, max=t - 1)  # (G, E*C)
    prob_flat = probs.reshape(g, t * k)
    safe_src = torch.clamp(slot_src, max=t * k - 1)
    w_slot = torch.where(slot_valid, torch.gather(prob_flat, 1, safe_src),
                         prob_flat.new_zeros(()))
    # Combine: each assignment's slot (the extra zero row where it was
    # dropped), a token's k outputs added in slot (= expert) order.
    slot_of = torch.full((g, t * k + 1), e * cap, dtype=torch.int64, device=x.device)
    slot_of.scatter_(1, slot_src, torch.arange(e * cap, device=x.device).expand(g, -1))
    order = torch.argsort(expert_idx, dim=-1)  # (G, T, k), distinct experts

    def experts(xg_, w_slot_, p_, lo: int, hi: int):
        """The weighted outputs of experts [lo, hi) combined per token (the
        other experts' slots zero)."""
        sl = slice(lo * cap, hi * cap)
        xe = torch.gather(xg_, 1, tok_of_slot[:, sl, None].expand(-1, -1, d))
        xe = xe * slot_valid[:, sl, None].to(xe.dtype)
        ye = _expert_ffn(xe.reshape(g, hi - lo, cap, d), p_, cfg).reshape(g, (hi - lo) * cap, d)
        y_flat = ye * w_slot_[:, sl, None].to(ye.dtype)
        if hi - lo < e:
            y_flat = torch.cat([y_flat.new_zeros((g, lo * cap, d)), y_flat,
                                y_flat.new_zeros((g, (e - hi) * cap, d))], dim=1)
        y_pad = torch.cat([y_flat, y_flat.new_zeros((g, 1, d))], dim=1)
        picked = torch.gather(y_pad, 1, slot_of[:, : t * k, None].expand(-1, -1, d))
        picked = picked.reshape(g, t, k, d)
        out = xg_.new_zeros((g, t, d), dtype=y_flat.dtype)
        for j in range(k):
            out = out + torch.gather(picked, 2, order[..., j, None, None].expand(-1, -1, 1, d))[
                :, :, 0]
        return out

    e_loc, f_loc = p0["w1"].shape[0], p0["w1"].shape[-1]
    split = model is not None and (e_loc < e or f_loc < cfg.d_ff)
    shared_split = (model is not None and cfg.shared_expert
                    and p0["shared_w1"].shape[-1] < cfg.d_ff)
    out = None if split else experts(xg, w_slot, p0, 0, e)
    if split or shared_split:
        xs = model.enter(xg)
        ws = model.enter(w_slot) if split else [None] * len(xs)
        parts = []
        for r, xr, wr, pr in zip(model.ranks, xs, ws, ps):
            part = None
            if split:
                lo, hi = model_bounds(e_loc, r) if e_loc < e else (0, e)
                part = experts(xr, wr, pr, lo, hi)
            if shared_split:
                sh = _shared(xr.reshape(g * t, d), pr).reshape(g, t, d)
                part = sh if part is None else part + sh
            parts.append(part)
        y = model.leave(parts)
        out = y if out is None else out + y
    if cfg.shared_expert and not shared_split:
        out = out + _shared(xg.reshape(g * t, d), p0).reshape(g, t, d)
    if not with_aux:
        return out.reshape(b, s, d)
    aux = load_balance_loss(logits.reshape(b * s, e), expert_idx.reshape(b * s, k), e,
                            batch=None if model is None else model.batch)
    return out.reshape(b, s, d), aux


def load_balance_loss(router_logits, expert_idx, n_experts: int, batch=None) -> torch.Tensor:
    """Switch-style auxiliary loss: E x sum over experts of (mean router
    probability) x (share of tokens whose first choice it is). ``batch``:
    the group of the data-parallel ranks whose rows make up the batch, over
    which both means are taken (``collectives.batch_mean``)."""
    probs = torch.softmax(router_logits, dim=-1)  # (T, E)
    me = probs.mean(0)
    first = expert_idx.reshape(-1, expert_idx.shape[-1])[:, 0]
    ce = F.one_hot(first, n_experts).to(probs.dtype).mean(0)
    if batch is not None:
        from repro_torch.distributed import collectives

        me, ce = collectives.batch_mean(me, batch), collectives.batch_mean(ce, batch)
    return n_experts * torch.sum(me * ce)
