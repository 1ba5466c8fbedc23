"""End-to-end training on the PyTorch/CUDA port: the fault-tolerant
trainer on a reduced LM.

Deterministic data pipeline, periodic SECDED-protected checkpoints, a
mid-run simulated node failure with automatic restore + replay, and
straggler monitoring.

Run: PYTHONPATH=src python examples/torch_train_lm.py --arch qwen3-0.6b --steps 200
[--device cpu] (the default device is the card; a run without one raises).

Data parallel over the ranks of a torchrun job, the state FSDP-sharded
(rank 0 prints, checkpoints and scrubs):
    PYTHONPATH=src torchrun --nproc-per-node 2 examples/torch_train_lm.py --mesh
Ranks that share a card join a gloo group; with a card per rank, NCCL.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import tempfile

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import FaultInjected, Trainer


def _join_mesh(device):
    """This torchrun rank's process group (its address, world size and rank
    from torchrun's environment) and the ("data", "model") mesh over it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    world = int(os.environ["WORLD_SIZE"])
    card = device is None or torch.device(device).type == "cuda"
    if card and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    backend = "nccl" if card and torch.cuda.device_count() >= world else "gloo"
    dist.init_process_group(backend)
    return make_host_mesh(device=device)


@contextlib.contextmanager
def _ckpt_dir(mesh):
    """A temporary checkpoint directory, one for every rank of a mesh."""
    if mesh is None:
        with tempfile.TemporaryDirectory() as d:
            yield d
        return
    import torch.distributed as dist

    box = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    try:
        yield box[0]
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(box[0], ignore_errors=True)


def main(argv=None) -> dict:
    """Train; returns the losses, recoveries and straggler count it prints."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fail-at", type=int, default=120,
                    help="simulate a node failure at this step (-1 = off)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--mesh", action="store_true",
                    help="data parallel over the ranks of a torchrun job, FSDP-sharded")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = _join_mesh(args.device) if args.mesh else None
    try:
        return _train(args, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _train(args, mesh) -> dict:
    from repro_torch.distributed.sharding import param_shardings

    rank0 = mesh is None or torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)

    cfg = get_smoke_config(args.arch)
    dc = DataConfig(vocab=cfg.vocab, global_batch=args.batch, seq_len=args.seq,
                    n_codebooks=cfg.n_codebooks)
    tc = TrainConfig(
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        remat=None,
    )

    armed = {"on": args.fail_at >= 0}

    def chaos(step):
        if armed["on"] and step == args.fail_at:
            armed["on"] = False
            say(f"*** simulated node failure at step {step} ***")
            raise FaultInjected("node lost")

    with _ckpt_dir(mesh) as ckpt_dir:
        tr = Trainer(
            cfg, tc, TokenPipeline(dc), ckpt_dir,
            ckpt_every=25, ecc_checkpoints=True, fault_hook=chaos,
            straggler_hook=lambda ev: say(
                f"straggler at step {ev.step}: {ev.seconds:.2f}s vs median {ev.median:.2f}s"
            ),
            device=args.device, mesh=mesh,
        )
        if mesh is not None:
            tr.rescale(mesh, param_shardings(cfg, mesh, fsdp=True))
        hist = tr.run(args.steps)
        losses = [h["loss"] for h in hist if "loss" in h]
        say(
            f"\narch={cfg.name} steps={len(losses)} "
            f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
            f"recoveries={tr.recoveries} stragglers={len(tr.straggler.events)}"
        )
        assert losses[-1] < losses[0], "loss should decrease"
    return {"losses": losses, "recoveries": tr.recoveries,
            "stragglers": len(tr.straggler.events)}


if __name__ == "__main__":
    main()
