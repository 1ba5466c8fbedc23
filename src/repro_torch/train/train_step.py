"""Train step: microbatched gradient accumulation + remat + AdamW.

``make_train_step(cfg, tcfg)`` returns a function
    (params, opt_state, batch) -> (params, opt_state, metrics)
that differentiates ``lm.train_loss`` with autograd and applies
``adamw.update``. Microbatching splits the global batch along B: each
microbatch's gradients are summed in float32 and divided by their count,
so live activation memory is 1/n of the batch's. Metrics stay tensors on
the parameters' device.
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    loss_fn = make_loss_fn(cfg, tcfg)

    def train_step(params, opt_state, batch):
        n = tcfg.microbatches
        if n <= 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            assert b % n == 0, (b, n)
            g_sum, l_sum = None, 0.0
            for i in range(n):
                mb = {k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
                loss, _, g = _value_and_grad(loss_fn, params, mb)
                g32 = [leaf.to(torch.float32) for _, leaf in base.flatten(g)]
                g_sum = g32 if g_sum is None else [a + c for a, c in zip(g_sum, g32)]
                l_sum = l_sum + loss
            grads = base.unflatten(params, [a / n for a in g_sum])
            loss = l_sum / n
            metrics = {}

        new_params, new_opt, opt_metrics = adamw.update(grads, opt_state, params,
                                                         tcfg.optimizer)
        out: dict[str, Any] = {"loss": loss, **opt_metrics}
        out.update(metrics or {})
        return new_params, new_opt, out

    return train_step


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig):
    loss_fn = make_loss_fn(cfg, tcfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return {"loss": loss, **metrics}

    return eval_step
