"""Train step: microbatched gradient accumulation + remat + AdamW.

``make_train_step(cfg, tcfg)`` returns a function
    (params, opt_state, batch) -> (params, opt_state, metrics)
that differentiates ``lm.train_loss`` with autograd and applies
``adamw.update``. Microbatching splits the global batch along B: each
microbatch's gradients are summed in float32 and divided by their count,
so live activation memory is 1/n of the batch's. Metrics stay tensors on
the parameters' device.

``make_mesh_train_step(cfg, tcfg, mesh)`` is the same function on a
process group's mesh, computed data-parallel: every leaf sharded by its
placement is gathered whole before the forward (the reference's GSPMD
shards the products over "model" instead; here the model axis holds
shards of the state and does no work), each rank takes its contiguous rows
of the global batch, the loss and gradients are averaged over the batch
axes in rank order (``collectives.dp_loss_and_grads``, which also states
the rule for a batch that does not split), and each rank updates its own
shard of the params and moments with the global gradient norm.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import base, lm
from repro_torch.models.base import ModelConfig
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatches: int = 1
    remat: str | None = "full"  # None | "full" | "dots"


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    def loss_fn(params, batch):
        return lm.train_loss(params, batch, cfg, remat=tcfg.remat)

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads): the gradient of every parameter leaf, in the
    leaf's dtype."""
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in base.flatten(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(base.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
    return loss.detach(), metrics, base.unflatten(params, grads)


def _loss_and_grads(loss_fn, tcfg: TrainConfig, params, batch):
    """(loss, metrics, grads) of ``batch``, in ``tcfg.microbatches``
    microbatches."""
    n = tcfg.microbatches
    if n <= 1:
        return _value_and_grad(loss_fn, params, batch)
    b = next(iter(batch.values())).shape[0]
    assert b % n == 0, (b, n)
    g_sum, l_sum = None, 0.0
    for i in range(n):
        mb = {k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
        loss, _, g = _value_and_grad(loss_fn, params, mb)
        g32 = [leaf.to(torch.float32) for _, leaf in base.flatten(g)]
        g_sum = g32 if g_sum is None else [a + c for a, c in zip(g_sum, g32)]
        l_sum = l_sum + loss
    return l_sum / n, {}, base.unflatten(params, [a / n for a in g_sum])


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    loss_fn = make_loss_fn(cfg, tcfg)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _loss_and_grads(loss_fn, tcfg, params, batch)
        new_params, new_opt, opt_metrics = adamw.update(grads, opt_state, params,
                                                         tcfg.optimizer)
        out: dict[str, Any] = {"loss": loss, **opt_metrics}
        out.update(metrics or {})
        return new_params, new_opt, out

    return train_step


def make_mesh_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh):
    """``make_train_step`` on ``mesh`` (a ``launch.mesh.HostMesh``), data
    parallel over its batch axes (see the module docstring). Params and
    moments are DTensors placed by a sharding, or plain tensors (replicated);
    every rank passes the same global batch."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shd

    loss_fn = make_loss_fn(cfg, tcfg)

    def train_step(params, opt_state, batch):
        loss, metrics, grads, _ = collectives.dp_loss_and_grads(
            loss_fn, tcfg, shd.gather(params), batch, mesh.batch_group, mesh.batch_index,
            mesh.n_batch)
        new_params, new_opt, opt_metrics = adamw.update(
            shd.shard_like(grads, params), shd.to_local(opt_state), shd.to_local(params),
            tcfg.optimizer, grad_norm=adamw.global_norm(grads))
        out: dict[str, Any] = {"loss": loss, **opt_metrics}
        out.update(metrics or {})
        return shd.like(new_params, params), shd.like(new_opt, opt_state), out

    return train_step


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig):
    loss_fn = make_loss_fn(cfg, tcfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return {"loss": loss, **metrics}

    return eval_step
