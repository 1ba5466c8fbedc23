"""The paper's §IV NN-accelerator case study on the PyTorch/CUDA port.

Trains the MLP accelerator on the synthetic-MNIST task, stores int8 weights
SECDED-encoded in the VC707 BRAM domain, undervolts V_CCBRAM from nominal to
V_crash, and reports classification error + power with and without ECC:
paper Fig. 3 as a table.

Run: PYTHONPATH=src python examples/torch_mnist_undervolt.py [--steps 600]
[--platform vc707] [--device cpu] (the default device is the card; a run
without one raises).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import voltage
from repro_torch.core.nn_accel import EccMLP
from repro_torch.data import mnist

SIZES = (784, 256, 128, 10)


def main(argv=None) -> dict:
    """Train, sweep the rail and print the table; returns its numbers."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--platform", default="vc707")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False

    xtr, ytr = mnist.make_dataset(20000, split="train")
    xte, yte = mnist.make_dataset(4000, split="test")
    mlp = EccMLP(SIZES, platform=args.platform, device=args.device)
    print("training the accelerator's MLP ...")
    loss = mlp.train(xtr, ytr, steps=args.steps)
    err0 = mlp.error_rate(xte, yte)
    print(f"train loss {loss:.4f}; fault-free error {100 * err0:.2f}% (paper 2.56%)\n")

    prof = voltage.PLATFORMS[args.platform]
    print(f"{'V':>5} | {'err ECC':>8} | {'err noECC':>9} | {'faulty words':>12} "
          f"| {'accel power':>11} | {'BRAM saving vs nom':>18}")
    vs = [prof.v_nom] + list(np.round(np.arange(prof.v_min, prof.v_crash - 1e-9, -0.01), 3))
    rows = []
    for v in vs:
        mlp.set_voltage(float(v), ecc=True)
        e1 = mlp.error_rate(xte, yte)
        fw = mlp.stats.faulty_words
        p = mlp.power_w()
        mlp.set_voltage(float(v), ecc=False)
        e0 = mlp.error_rate(xte, yte)
        sav = 1 - voltage.bram_power(float(v), ecc=True) / voltage.bram_power(prof.v_nom)
        print(f"{v:5.2f} | {100 * e1:7.2f}% | {100 * e0:8.2f}% | {fw:12d} "
              f"| {p:9.2f} W | {100 * sav:17.1f}%")
        rows.append({"v": float(v), "err_ecc": e1, "err_no_ecc": e0, "faulty_words": fw,
                     "power_w": p, "bram_saving": sav})

    mlp.set_voltage(prof.v_crash, ecc=True)
    e1 = mlp.error_rate(xte, yte)
    accel_saving = 1 - voltage.accelerator_power(prof.v_crash) / voltage.accelerator_power(
        prof.v_nom, ecc=False)
    print(
        f"\n@V_crash with ECC: error {100 * e1:.2f}% (+{100 * (e1 - err0):.2f} vs fault-free; "
        f"paper +0.56); accelerator power saving nom->crash "
        f"{100 * accel_saving:.1f}% "
        f"(paper 25.2%)"
    )
    return {"loss": loss, "err0": err0, "rows": rows, "err_crash": e1,
            "accel_saving": accel_saving}


if __name__ == "__main__":
    main()
