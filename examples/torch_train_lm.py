"""End-to-end training on the PyTorch/CUDA port: the fault-tolerant
trainer on a reduced LM.

Deterministic data pipeline, periodic SECDED-protected checkpoints, a
mid-run simulated node failure with automatic restore + replay, and
straggler monitoring.

Run: PYTHONPATH=src python examples/torch_train_lm.py --arch qwen3-0.6b --steps 200
[--device cpu] (the default device is the card; a run without one raises).
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import FaultInjected, Trainer


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
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False

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
            print(f"*** simulated node failure at step {step} ***")
            raise FaultInjected("node lost")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tr = Trainer(
            cfg, tc, TokenPipeline(dc), ckpt_dir,
            ckpt_every=25, ecc_checkpoints=True, fault_hook=chaos,
            straggler_hook=lambda ev: print(
                f"straggler at step {ev.step}: {ev.seconds:.2f}s vs median {ev.median:.2f}s"
            ),
            device=args.device,
        )
        hist = tr.run(args.steps)
        losses = [h["loss"] for h in hist if "loss" in h]
        print(
            f"\narch={cfg.name} steps={len(losses)} "
            f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
            f"recoveries={tr.recoveries} stragglers={len(tr.straggler.events)}"
        )
        assert losses[-1] < losses[0], "loss should decrease"
    return {"losses": losses, "recoveries": tr.recoveries,
            "stragglers": len(tr.straggler.events)}


if __name__ == "__main__":
    main()
