"""AdamW with a configurable moment dtype (bf16 moments for 100B+ models).

Plain functions on the parameter dict, the reference's formula step for
step: the gradients are clipped by their global norm, the moments and
their bias corrections are float32, weight decay enters the step as
``weight_decay * p`` beside the normalised moment, and the new parameter is
cast back to the parameter's dtype. (``torch.optim.AdamW`` decays the
parameter before the step, which gives other floats.) The state is
{"m", "v", "step"}, ``step`` a 0-d int32 tensor; the learning rate and the
gradient norm stay on the parameters' device, so an update never waits for
the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models import base


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = None  # None -> float32 moments; torch.bfloat16 for 100B+
    warmup_steps: int = 100
    total_steps: int = 10_000


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to 10%, in float32 (``step`` an int
    tensor)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * frac)
    return cfg.lr * warm * cos


def init(params, cfg: AdamWConfig):
    """Zero moments in ``cfg.state_dtype`` (float32 by default) on each
    parameter's device, and step 0."""
    dt = cfg.state_dtype or torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = next(iter(base.flatten(params)))[1].device
    return {
        "m": base.tree_map(zeros, params),
        "v": base.tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree, sharded=None, psum=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.

    Over one rank's shards: ``sharded`` marks (in flatten order) the
    leaves of which the rank holds a shard on the "model" axis; their
    squares are summed (``square_sums``) and the sum added over the axis by
    ``psum``, and every other leaf, replicated, is counted once."""
    if sharded is None:
        leaves = [leaf for _, leaf in base.flatten(tree)]
        return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32))) for l in leaves))
    part, rest = square_sums(tree, sharded)
    return torch.sqrt(psum(part) + rest)


def square_sums(tree, sharded) -> tuple:
    """(the float32 sum of squares of the leaves marked in ``sharded``, that
    of the others), each summed over leaves in flatten order from 0."""
    leaves = [leaf for _, leaf in base.flatten(tree)]
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    part, rest = zero, zero
    for leaf, mark in zip(leaves, sharded, strict=True):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        if mark:
            part = part + sq
        else:
            rest = rest + sq
    return part, rest


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig, grad_norm=None):
    """Returns (new_params, new_state, metrics {"lr", "grad_norm"}).
    ``grad_norm`` is the gradients' global norm where ``grads``, ``state``
    and ``params`` hold one rank's shards (the update is elementwise but
    for the clip); None computes it from ``grads``."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, sf)
    bc2 = 1.0 - torch.pow(b2, sf)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32) * clip
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
        mh = m32 / bc1
        vh = v32 / bc2
        step_p = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * step_p
        return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    flat_p = base.flatten(params)
    leaves = [leaf for _, leaf in flat_p]
    out = [upd(p, g, m, v) for p, (_, g), (_, m), (_, v) in zip(
        leaves, base.flatten(grads), base.flatten(state["m"]), base.flatten(state["v"]))]
    new_params = base.unflatten(params, [o[0] for o in out])
    new_m = base.unflatten(params, [o[1] for o in out])
    new_v = base.unflatten(params, [o[2] for o in out])
    return new_params, {"m": new_m, "v": new_v, "step": step}, {"lr": lr, "grad_norm": gnorm}
