"""One rank of the port's model-axis checks for the rwkv6, hybrid (mamba),
vlm and audio families (tests/test_torch_tp_families.py).

    python tests/_torch_tp_families_ranks.py RANK WORLD WORKDIR

Joins a ``gloo`` group of WORLD ranks through ``file://WORKDIR/pg`` on the
CPU, runs ``body`` and exits non-zero if any check of it fails. ``body``
reads the reference's parameters and each config's batch (tokens and
labels, an audio config's (B, K, S), a vlm's image embeddings) from
``WORKDIR/inputs.npz`` and writes this rank's results to
``WORKDIR/port_r{RANK}.npz`` and ``.json``. It imports neither JAX nor the
reference package.
"""

import json
import os
import sys

import numpy as np
import torch

import _torch_tp_ranks as dense

BASE_KW = dense.BASE_KW
CONFIGS = {
    "rwkv": dict(family="ssm", n_kv_heads=4, rwkv_head_dim=16, norm_type="layernorm"),
    # three heads: the rule leaves time-mix and the receptance gate whole on
    # two ranks, while "ffn" and the vocab still shard
    "rwkv3": dict(family="ssm", d_model=48, n_heads=3, n_kv_heads=3, rwkv_head_dim=16),
    # one period: mamba at p0-p3 and p5-p7, attention at p4, MoE at odd positions
    "hybrid": dict(family="hybrid", n_layers=8, attn_every=8, n_experts=4, top_k=2),
    # cross-attention at p4 over 8 image tokens
    "vlm": dict(family="vlm", n_layers=5, cross_attn_every=5, n_img_tokens=8, qk_norm=True),
    "audio": dict(family="audio", n_codebooks=4, n_kv_heads=4, norm_type="layernorm",
                  gated_mlp=False),
}
FAMILIES = ("rwkv", "hybrid", "vlm", "audio")
# (config, mesh shape) a world size
CASES = {2: [(n, (1, 2)) for n in FAMILIES] + [("rwkv3", (1, 2))],
         4: [(n, s) for s in ((2, 2), (1, 4)) for n in FAMILIES]}
TRAJ = {2: (1, 2), 4: (2, 2)}  # the 12-step trainers' mesh a world size
TRAJ_CONFIGS = ("rwkv", "hybrid")
DC_KW = dense.DC_KW  # seq_len 32: one chunk of the recurrent scans
OPT_KW = dense.OPT_KW
TRAJ_STEPS = dense.TRAJ_STEPS


def cfg_kw(name: str) -> dict:
    return {**BASE_KW, **CONFIGS[name]}


def _setup(name: str):
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.base import ModelConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    cfg = ModelConfig(**cfg_kw(name))
    return (cfg, TrainConfig(optimizer=AdamWConfig(**OPT_KW), remat="full"),
            TokenPipeline(DataConfig(**DC_KW, n_codebooks=cfg.n_codebooks)))


def _tree(inputs, prefix: str) -> dict:
    tree = {}
    for k in inputs.files:
        if k.startswith(prefix):
            node = tree
            *path, leaf = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = inputs[k]
    return tree


def _params(inputs, name: str, cfg):
    from repro_torch.models import base

    return base.params_from_numpy(_tree(inputs, f"P{name}/"), cfg, device="cpu")


def _batch(inputs, name: str) -> dict:
    return {k: torch.from_numpy(v) for k, v in _tree(inputs, f"B{name}/").items()}


def _case(name, shape, inputs, tag, out, info):
    """The model-axis step of config ``name`` on a ``shape`` mesh: this
    rank's gradients before and after the sum over "model", its params
    after the step (gathered over the batch axes), the gather counters."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import base, lm
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts

    cfg, tc, _ = _setup(name)
    batch = _batch(inputs, name)
    mesh = make_host_mesh(model=shape[1], device="cpu")
    assert mesh.shape == {"data": shape[0], "model": shape[1]}
    full = _params(inputs, name, cfg)
    ps = shd.param_shardings(cfg, mesh, fsdp=True)
    params = shd.place(full, ps)
    opt = adamw.init(full, tc.optimizer)
    opt = {"m": shd.place(opt["m"], ps), "v": shd.place(opt["v"], ps), "step": opt["step"]}
    assert shd.placed_by_rules(params, cfg, mesh)

    # the raw gradients (before the sum over "model") and the step
    axis = coll.ModelAxis.of_mesh(mesh, split_batch=mesh.n_batch > 1)
    local = shd.gather(params, shd.batch_axes(mesh))
    _, _, raw, _ = coll.dp_loss_and_grads(
        lambda p, b: lm.train_loss({mesh.model_index: p}, b, cfg, remat=tc.remat, model=axis),
        tc, local, batch, mesh.batch_group, mesh.batch_index, mesh.n_batch)
    partial = set(lm.model_partial_keys(cfg, mesh.n_model))
    summed = ts._sum_over_model(raw, partial, lambda t: coll.psum(t, mesh.model_group))
    shd.reset_gathered_bytes()
    coll.reset_activation_gathered_bytes()
    p1, o1, m1 = ts.make_mesh_train_step(cfg, tc, mesh)(params, opt, batch)
    gathered = shd.gathered_bytes()
    activations = coll.activation_gathered_bytes()
    again, _, m2 = ts.make_mesh_train_step(cfg, tc, mesh)(params, opt, batch)
    emulated = None
    if mesh.n_batch == 1:  # the one-process emulation, this rank's branch bit for bit
        loss_e, ranks_e = ts.emulate_model_step(cfg, tc, mesh.n_model, full,
                                                adamw.init(full, tc.optimizer), batch)
        pe, oe = ranks_e[mesh.model_index]
        emulated = float(loss_e) == float(m1["loss"]) and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                base.flatten({"p": pe, "m": oe["m"], "v": oe["v"]}),
                base.flatten({"p": shd.to_local(p1), "m": shd.to_local(o1["m"]),
                              "v": shd.to_local(o1["v"])})))
    out.update({f"{tag}raw{k}": v for k, v in dense._flat(raw).items()})
    out.update({f"{tag}grad{k}": v for k, v in dense._flat(summed).items()})
    out.update({f"{tag}param{k}": v for k, v in
                dense._flat(shd.gather(p1, shd.batch_axes(mesh))).items()})
    info[tag] = {
        "loss": float(m1["loss"]), "model_index": mesh.model_index,
        "batch_index": mesh.batch_index, "gathered": gathered,
        "activation_bytes": activations,
        "repeat_bitwise": float(m2["loss"]) == float(m1["loss"]) and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(base.flatten(shd.to_local(p1)),
                                                         base.flatten(shd.to_local(again)))),
        "local_sizes": {k: list(v.to_local().shape) for k, v in base.flatten(params)},
        "model_dims": {k: shd.model_dim(v) for k, v in base.flatten(params)},
        "partial": sorted(partial), "emulation_bitwise": emulated,
        "moments_local": all(
            isinstance(v, torch.distributed.tensor.DTensor) and v.placements == w.placements
            for (_, v), (_, w) in zip(base.flatten(o1["m"]), base.flatten(params))),
    }


def body(workdir: str) -> None:
    """Every check of this world size, on the initialised default group."""
    import torch.distributed as dist

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import base
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer

    rank, world = dist.get_rank(), dist.get_world_size()
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    out, info = {}, {}

    # 1. the model-axis step of every case against the reference (in the test)
    for name, shape in CASES[world]:
        _case(name, shape, inputs, f"{name}_{shape[0]}x{shape[1]}/", out, info)

    # 2. a model axis of one rank: the data-parallel step, every leaf gathered whole
    cfg, tc, _ = _setup("rwkv")
    batch = _batch(inputs, "rwkv")
    full = _params(inputs, "rwkv", cfg)
    mesh1 = make_host_mesh(device="cpu")
    ps1 = shd.param_shardings(cfg, mesh1, fsdp=True)
    params, opt = shd.place(full, ps1), adamw.init(full, tc.optimizer)
    opt = {"m": shd.place(opt["m"], ps1), "v": shd.place(opt["v"], ps1), "step": opt["step"]}
    p1, o1, m1 = ts.make_mesh_train_step(cfg, tc, mesh1)(params, opt, batch)
    loss, _, grads, _ = coll.dp_loss_and_grads(ts.make_loss_fn(cfg, tc), tc, shd.gather(params),
                                               batch, mesh1.batch_group, mesh1.batch_index,
                                               mesh1.n_batch)
    p33, o33, _ = adamw.update(shd.shard_like(grads, params), shd.to_local(opt),
                               shd.to_local(params), tc.optimizer,
                               grad_norm=adamw.global_norm(grads))
    info["model_one_bitwise"] = bool(torch.equal(m1["loss"], loss) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            base.flatten({"p": shd.to_local(p1), "o": shd.to_local(o1)}),
            base.flatten({"p": p33, "o": o33}))))

    # 3. a 12-step trainer on the model axis a config, from the reference's params
    shape = TRAJ[world]
    mesh = make_host_mesh(model=shape[1], device="cpu")
    trainers = {}
    for name in TRAJ_CONFIGS:
        cfg, tc, pipe = _setup(name)
        ps = shd.param_shardings(cfg, mesh, fsdp=True)
        full = _params(inputs, name, cfg)
        tr = Trainer(cfg, tc, pipe, os.path.join(workdir, f"traj_{name}"), ckpt_every=100,
                     mesh=mesh, param_shardings=ps, seed=0)
        tr.params, tr.opt_state = full, adamw.init(full, tc.optimizer)
        tr.rescale(mesh, ps)
        shd.reset_gathered_bytes()
        info[f"traj_{name}"] = [r["loss"] for r in tr.run(TRAJ_STEPS) if "loss" in r]
        info[f"traj_gathered_{name}"] = shd.gathered_bytes()
        trainers[name] = (tr, ps)

    # 4. (two ranks) rwkv6: rescale between (1, 2) and (2, 1), an ECC save at
    # (1, 2) and its load resharded onto (2, 1), both bit for bit
    if world == 2:
        tr, ps = trainers["rwkv"]
        cfg = tr.cfg
        mesh21 = make_host_mesh(model=1, device="cpu")
        ps21 = shd.param_shardings(cfg, mesh21, fsdp=True)
        before = dense._flat({k: shd.gather_leaf(v) for k, v in base.flatten(tr._state())})
        tr.rescale(mesh21, ps21)
        mid = dense._flat({k: shd.gather_leaf(v) for k, v in base.flatten(tr._state())})
        info["rescale_to_21_bitwise"] = all(np.array_equal(before[k], mid[k]) for k in before)
        info["rescale_losses"] = [tr.run(1)[-1]["loss"]]
        tr.rescale(mesh, ps)
        info["rescale_losses"].append(tr.run(1)[-1]["loss"])
        d = os.path.join(workdir, "ecc12")
        tr.ckpt_dir, tr.ecc_checkpoints = d, True
        tr.save()
        saved = {k: shd.gather_leaf(v) for k, v in base.flatten(tr._state())}
        sh21 = {"params": ps21, "opt": {"m": ps21, "v": ps21, "step": shd.replicated(mesh21)}}
        back = ckpt.load(d, tr.step, tr._state(), shardings=sh21)
        info["ecc_reshard_bitwise"] = all(
            torch.equal(v.to_local(), shd.local_slice(saved[k], v.device_mesh, v.placements))
            and v.placements == tuple(shd.placements(mesh21, s.spec))
            for (k, v), (_, s) in zip(base.flatten(back), base.flatten(
                sh21, is_leaf=lambda x: isinstance(x, shd.NamedSharding)))
            if isinstance(v, torch.distributed.tensor.DTensor))

    np.savez(os.path.join(workdir, f"port_r{rank}.npz"), **out)
    with open(os.path.join(workdir, f"port_r{rank}.json"), "w") as f:
        json.dump(info, f)


def main(argv) -> int:
    import torch.distributed as dist

    rank, world, workdir = int(argv[0]), int(argv[1]), argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'pg')}",
                            world_size=world, rank=rank)
    try:
        body(workdir)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
