"""One rank of the port's data-parallel checks (tests/test_torch_dp.py).

    python tests/_torch_dp_ranks.py RANK WORLD WORKDIR

Joins a ``gloo`` group of WORLD ranks through ``file://WORKDIR/pg`` on the
CPU, runs ``body`` and exits non-zero if any check of it fails. ``body``
reads the shared inputs from ``WORKDIR/inputs.npz`` (the reference's
parameters, a batch, gradients and error-feedback buffers per rank) and
writes this rank's results to ``WORKDIR/port_r{RANK}.npz`` and
``.json``. It imports neither JAX nor the reference package; the test
process, which has both, runs ``body`` itself at one rank.
"""

import json
import os
import sys

import numpy as np
import torch

CFG_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=64, head_dim=16)
DC_KW = dict(vocab=64, global_batch=8, seq_len=32)
OPT_KW = dict(lr=1e-3, warmup_steps=5, total_steps=100)
TRAJ_STEPS = 12
RAILS_KW = dict(scrub_every=4, start_v=0.60)  # rank 0 scrubs the gathered params


def _setup():
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.base import ModelConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    return (ModelConfig(**CFG_KW), TrainConfig(optimizer=AdamWConfig(**OPT_KW), remat=None),
            TokenPipeline(DataConfig(**DC_KW)))


def _params(inputs, cfg):
    from repro_torch.models import base

    tree = {}
    for k in inputs.files:
        if k.startswith("P"):
            node = tree
            *path, leaf = k[1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = inputs[k]
    return base.params_from_numpy(tree, cfg, device="cpu")


def _flat_np(tree) -> dict:
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import base

    return {k: shd.gather_leaf(v).detach().cpu().numpy() for k, v in base.flatten(tree)}


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
    from repro_torch.train.trainer import FaultInjected, RailPolicy, Trainer

    rank, world = dist.get_rank(), dist.get_world_size()
    cfg, tc, pipe = _setup()
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    out, info = {}, {}
    mesh = make_host_mesh(device="cpu")

    # 1. quantize and the compressed mean of fixed gradients, leaf by leaf
    for i in range(int(inputs["n_leaves"])):
        g = torch.from_numpy(inputs[f"G{i}"][rank])
        e = torch.from_numpy(inputs[f"E{i}"][rank])
        q, scale = coll.quantize_int8(g)
        avg, ef = coll.compressed_psum(g, e)
        out.update({f"q{i}": q.numpy(), f"scale{i}": scale.numpy(), f"avg{i}": avg.numpy(),
                    f"ef{i}": ef.numpy()})

    # 2. the data-parallel step on the reference's params and batch
    params = _params(inputs, cfg)
    batch = {"tokens": torch.from_numpy(inputs["tokens"]),
             "labels": torch.from_numpy(inputs["labels"])}
    opt = adamw.init(params, tc.optimizer)
    ef0 = coll.init_error_feedback(params)
    loss_fn = ts.make_loss_fn(cfg, tc)
    for tag, compress in (("c", True), ("u", False)):
        loss, _, grads, ef = coll.dp_loss_and_grads(loss_fn, tc, params, batch, mesh.batch_group,
                                                    mesh.batch_index, mesh.n_batch,
                                                    ef0 if compress else None)
        step = coll.make_dp_compressed_train_step(cfg, tc, mesh, compress=compress)
        p1, _, ef1, loss1 = step(params, opt, ef0, batch)
        assert float(loss1) == float(loss)
        info[f"loss_{tag}"] = float(loss)
        out.update({f"grad_{tag}{k}": v for k, v in _flat_np(grads).items()})
        out.update({f"param_{tag}{k}": v for k, v in _flat_np(p1).items()})
        out.update({f"ef_{tag}{k}": v for k, v in _flat_np(ef1).items()})

    # 3. reshard on load: each rank keeps its slice of the saved leaf
    d = os.path.join(workdir, "ckpt_reshard")
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    ckpt.save(d, 1, {"w": w, "b": torch.ones(3)}, ecc_protect=True, group=mesh.group)
    shards = {"w": shd.NamedSharding(mesh, shd.P("data")), "b": shd.replicated(mesh)}
    back = ckpt.load(d, 1, {"w": w, "b": torch.ones(3)}, shardings=shards)
    rows = 8 // world
    assert torch.equal(back["w"].to_local(), w[rank * rows:(rank + 1) * rows])
    assert torch.equal(shd.gather_leaf(back["w"]), w)
    assert back["w"].placements == tuple(shd.placements(mesh, shd.P("data")))
    assert torch.equal(back["b"].to_local(), torch.ones(3))
    try:  # a tree of DTensors is saved by every rank of its mesh, never by one alone
        ckpt.save(os.path.join(workdir, "alone"), 1, back)
        raise AssertionError("a DTensor tree was saved without its group")
    except ValueError as e:
        assert "group=" in str(e)

    # 4. an elastic rescale keeps the state bit for bit, and training goes on
    tr = Trainer(cfg, tc, pipe, os.path.join(workdir, "rescale"), ckpt_every=100, mesh=mesh,
                 seed=0)
    tr.run(3)
    l3 = tr.history[-1]["loss"]
    before = _flat_np(tr._state())
    tr.rescale(mesh, shd.param_shardings(cfg, mesh, fsdp=True))
    sharded = _flat_np(tr._state())
    assert isinstance(tr.params["embed"], torch.distributed.tensor.DTensor)
    tr.rescale(mesh)
    assert all(isinstance(v, torch.Tensor) and type(v) is torch.Tensor
               for _, v in base.flatten(tr.params))
    after = _flat_np(tr._state())
    assert before.keys() == sharded.keys() == after.keys()
    assert all(np.array_equal(before[k], sharded[k]) and np.array_equal(before[k], after[k])
               for k in before)
    h = tr.run(1)
    info["rescale_losses"] = [l3, h[-1]["loss"]]

    # 5. a 12-step sharded trainer with ECC checkpoints, and its resume
    d = os.path.join(workdir, "traj")
    ps = shd.param_shardings(cfg, mesh, fsdp=True)
    tr = Trainer(cfg, tc, pipe, d, ckpt_every=5, ecc_checkpoints=True, mesh=mesh,
                 param_shardings=ps, seed=0, rails=RailPolicy(**RAILS_KW))
    tr.params = params
    tr.opt_state = adamw.init(params, tc.optimizer)
    tr.rescale(mesh, ps)
    hist = tr.run(TRAJ_STEPS)
    info["traj"] = [r["loss"] for r in hist if "loss" in r]
    info["rails"] = [{k: r[k] for k in ("step", "voltages", "locked", "detected")}
                     for r in hist if r.get("event") == "rails"]
    res = Trainer(cfg, tc, pipe, d, ckpt_every=100, mesh=mesh, param_shardings=ps)
    assert res.restore() and res.step == 10
    assert isinstance(res.params["embed"], torch.distributed.tensor.DTensor)
    info["resumed"] = [r["loss"] for r in res.run(2) if "loss" in r]
    final_a, final_b = _flat_np(tr._state()), _flat_np(res._state())
    info["resume_bitwise"] = all(np.array_equal(final_a[k], final_b[k]) for k in final_a)

    # 6. a batch whose rows do not split over the ranks: every rank computes
    # it whole and no collective runs (the reference replicates such a batch)
    odd = {k: v[:7] for k, v in batch.items()}
    whole, _, g_whole = ts._loss_and_grads(loss_fn, tc, params, odd)
    loss, _, grads, _ = coll.dp_loss_and_grads(loss_fn, tc, params, odd, mesh.batch_group,
                                               mesh.batch_index, mesh.n_batch)
    info["odd_batch_whole"] = bool(torch.equal(loss, whole) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(base.flatten(grads), base.flatten(g_whole))))

    # 7. a trainer without a mesh keeps its own checkpoints in a process group
    own = os.path.join(workdir, f"own_r{rank}")
    tiny = Trainer(cfg, tc, pipe, own, ckpt_every=1, device="cpu")
    tiny.run(2)
    again = Trainer(cfg, tc, pipe, own, device="cpu")
    info["own_checkpoints"] = sorted(ckpt.all_steps(own))
    info["own_restore"] = again.restore() and again.step == 2

    # 8. a fault before the first checkpoint on a sharded trainer: re-initialised
    # and placed by its shardings again
    def fault_at_0(step, fired=[]):
        if step == 0 and not fired:
            fired.append(step)
            raise FaultInjected("step 0")

    ps = shd.param_shardings(cfg, mesh, fsdp=True)
    tr = Trainer(cfg, tc, pipe, os.path.join(workdir, "fault0"), ckpt_every=100, mesh=mesh,
                 param_shardings=ps, fault_hook=fault_at_0)
    tr.rescale(mesh, ps)
    tr.run(1)
    dtensor = torch.distributed.tensor.DTensor
    info["fault0"] = {"recoveries": tr.recoveries, "step": tr.step,
                      "placed": all(isinstance(v, dtensor) for _, v in base.flatten(
                          {"params": tr.params, "m": tr.opt_state["m"],
                           "v": tr.opt_state["v"]}))}

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
