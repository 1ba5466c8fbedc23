"""Train step: microbatched gradient accumulation + remat + AdamW.

``make_train_step(cfg, tcfg)`` returns a function
    (params, opt_state, batch) -> (params, opt_state, metrics)
that differentiates ``lm.train_loss`` with autograd and applies
``adamw.update``. Microbatching splits the global batch along B: each
microbatch's gradients are summed in float32 and divided by their count,
so live activation memory is 1/n of the batch's. Metrics stay tensors on
the parameters' device.

``make_mesh_train_step(cfg, tcfg, mesh)`` is the same function on a
process group's mesh. Each rank takes its contiguous rows of the global
batch over the batch axes, the loss and gradients are averaged over them in
rank order (``collectives.dp_loss_and_grads``, which also states the rule
for a batch that does not split), and each rank updates its own shards of
the params and moments with the global gradient norm. On the "model" axis
the step computes as the rules place the leaves, for every family: a leaf
sharded over "model" is never gathered whole; the leaves are gathered over
the batch axes only, the forward runs tensor- and expert-parallel on the
local shards (``lm.train_loss(model=)``), whose partial results and
activation slices meet in explicit collectives, the sharded leaves'
gradients stay local, the replicated leaves read inside a sharded region
(``lm.model_partial_keys``) have their gradients summed over "model", and
the norm sums the sharded leaves' squares over "model" once. A model axis
of one rank, or leaves placed otherwise on "model", take the data-parallel
step with every leaf gathered whole.
``emulate_model_step`` computes the model-axis step of a (1, n) mesh in one
process, each rank's branch in turn, for checks against the ranks.
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


def _sum_over_model(grads, keys, total):
    """``grads`` with the leaves at ``keys`` replaced by ``total`` of them,
    in one call a dtype on their flattened concatenation."""
    flat = base.flatten(grads)
    leaves = [g for _, g in flat]
    picked = [i for i, (k, _) in enumerate(flat) if k in keys]
    for dt in {leaves[i].dtype for i in picked}:
        idx = [i for i in picked if leaves[i].dtype == dt]
        summed = total(torch.cat([leaves[i].reshape(-1) for i in idx]))
        for i, part in zip(idx, torch.split(summed, [leaves[i].numel() for i in idx])):
            leaves[i] = part.reshape(leaves[i].shape)
    return base.unflatten(grads, leaves)


def make_mesh_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh):
    """``make_train_step`` on ``mesh`` (a ``launch.mesh.HostMesh``),
    data-parallel over its batch axes and tensor- and expert-parallel over
    "model" (see the module docstring). Params and moments are DTensors
    placed by a sharding, or plain tensors (replicated); every rank passes
    the same global batch."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shd

    loss_fn = make_loss_fn(cfg, tcfg)
    on_model = mesh.n_model > 1
    partial = set(lm.model_partial_keys(cfg, mesh.n_model))
    batch_axes = shd.batch_axes(mesh)
    # the batch split over the batch axes or not (dp_loss_and_grads' rule)
    axes = {split: collectives.ModelAxis.of_mesh(mesh, split) for split in (False, True)}

    def whole_step(params, opt_state, batch):
        loss, metrics, grads, _ = collectives.dp_loss_and_grads(
            loss_fn, tcfg, shd.gather(params), batch, mesh.batch_group, mesh.batch_index,
            mesh.n_batch)
        new_params, new_opt, opt_metrics = adamw.update(
            shd.shard_like(grads, params), shd.to_local(opt_state), shd.to_local(params),
            tcfg.optimizer, grad_norm=adamw.global_norm(grads))
        return new_params, new_opt, loss, metrics, opt_metrics

    def model_step(params, opt_state, batch):
        rows = next(iter(batch.values())).shape[0]
        axis = axes[mesh.n_batch > 1 and rows % mesh.n_batch == 0]
        loss, metrics, grads, _ = collectives.dp_loss_and_grads(
            lambda p, b: lm.train_loss({mesh.model_index: p}, b, cfg, remat=tcfg.remat,
                                       model=axis), tcfg,
            shd.gather(params, batch_axes), batch, mesh.batch_group, mesh.batch_index,
            mesh.n_batch)
        grads = _sum_over_model(grads, partial,
                                lambda t: collectives.psum(t, mesh.model_group))
        sharded = [shd.model_dim(leaf) is not None for _, leaf in base.flatten(params)]
        gnorm = adamw.global_norm(grads, sharded,
                                  lambda t: collectives.psum(t, mesh.model_group))
        new_params, new_opt, opt_metrics = adamw.update(
            shd.shard_like(grads, params, batch_axes), shd.to_local(opt_state),
            shd.to_local(params), tcfg.optimizer, grad_norm=gnorm)
        return new_params, new_opt, loss, metrics, opt_metrics

    def train_step(params, opt_state, batch):
        step = (model_step if on_model and shd.placed_by_rules(params, cfg, mesh)
                else whole_step)
        new_params, new_opt, loss, metrics, opt_metrics = step(params, opt_state, batch)
        out: dict[str, Any] = {"loss": loss, **opt_metrics}
        out.update(metrics or {})
        return shd.like(new_params, params), shd.like(new_opt, opt_state), out

    return train_step


def emulate_model_step(cfg: ModelConfig, tcfg: TrainConfig, n_model: int, params, opt_state,
                       batch):
    """``make_mesh_train_step``'s model-axis step on a (1, ``n_model``) mesh
    placed by the rules, computed in one process: whole ``params`` and
    ``opt_state`` are cut into each rank's local shards, the forward runs
    every rank's branch in turn (``collectives.ModelAxis.emulated``), and
    every sum over the ranks adds their parts in rank order, as the
    ranks' collectives do, so each rank's result is the same bits.
    Returns (loss, [(new local params, new local opt state) of each model
    rank])."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import abstract_mesh

    if tcfg.microbatches > 1:
        raise ValueError("the emulation takes one microbatch")
    n = int(n_model)
    rules = base.flatten(shd.param_shardings(cfg, abstract_mesh((1, n), ("data", "model")),
                                             fsdp=False),
                         is_leaf=lambda x: isinstance(x, shd.NamedSharding))
    dims = [next((d for d, e in enumerate(r.spec) if e == "model"), None) for _, r in rules]
    partial = set(lm.model_partial_keys(cfg, n))

    def cut(t, d, r):
        if d is None:
            return t
        size = t.shape[d] // n
        return t.narrow(d, r * size, size).contiguous()

    flat = base.flatten(params)
    per_rank = []  # each leaf's tensor in each rank's tree
    for (key, t), d in zip(flat, dims, strict=True):
        if d is not None or key in partial:  # a leaf of its own a rank
            per_rank.append([cut(t, d, r).detach().requires_grad_(True) for r in range(n)])
        else:  # one leaf, read once outside the regions
            one = t.detach().requires_grad_(True)
            per_rank.append([one] * n)
    trees = {r: base.unflatten(params, [leaves[r] for leaves in per_rank]) for r in range(n)}
    unique = list({id(t): t for leaves in per_rank for t in leaves}.values())
    with torch.enable_grad():
        loss, _ = lm.train_loss(trees, batch, cfg, remat=tcfg.remat,
                                model=collectives.ModelAxis.emulated(n))
        gs = torch.autograd.grad(loss, unique, allow_unused=True)
    grad_of = {id(t): torch.zeros_like(t) if g is None else g for t, g in zip(unique, gs)}

    def rank_sum(parts):
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    grads = []
    for r in range(n):
        leaves = []
        for (key, _), d, ts in zip(flat, dims, per_rank):
            if key in partial:
                leaves.append(rank_sum([grad_of[id(t)] for t in ts]))
            else:
                leaves.append(grad_of[id(ts[r])])
        grads.append(base.unflatten(params, leaves))
    sharded = [d is not None for d in dims]
    sums = [adamw.square_sums(g, sharded) for g in grads]
    gnorm = torch.sqrt(rank_sum([part for part, _ in sums]) + sums[0][1])
    out = []
    for r in range(n):
        local = lambda tree: base.unflatten(tree, [cut(t, d, r) for (_, t), d in zip(
            base.flatten(tree), dims)])
        opt_r = {"m": local(opt_state["m"]), "v": local(opt_state["v"]),
                 "step": opt_state["step"]}
        new_p, new_opt, _ = adamw.update(grads[r], opt_r, local(params), tcfg.optimizer,
                                         grad_norm=gnorm)
        out.append((new_p, new_opt))
    return loss.detach(), out


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig):
    loss_fn = make_loss_fn(cfg, tcfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return {"loss": loss, **metrics}

    return eval_step
