"""Quickstart on the PyTorch/CUDA port: the paper's mechanism in one page.

1. Put an array into an ECC-protected "BRAM" voltage domain.
2. Undervolt below V_min: faults appear at the calibrated exponential rate.
3. Read through the SECDED decoder: >90% corrected, ~7% detected.
4. Let the DED-canary controller find the minimum safe voltage at runtime.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the default device is the card; a run without one raises).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    EccMemoryDomain,
    FaultStats,
    PLATFORMS,
    UndervoltController,
    voltage,
)

SWEEP = (1.0, 0.61, 0.58, 0.56, 0.54)


def main(argv=None) -> dict:
    """Run the tour; returns the numbers it prints."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.default_rng(0)
    weights = rng.standard_normal((512, 1024)).astype(np.float32)

    # 1. Write into the domain (SECDED(72,64)-encoded word planes).
    dom = EccMemoryDomain(platform="vc707", seed=42, device=args.device)
    dom.write("weights", weights)

    # 2-3. Sweep the rail through the critical region.
    prof = PLATFORMS["vc707"]
    print(f"V_nom={prof.v_nom} V_min={prof.v_min} V_crash={prof.v_crash} "
          f"(guardband {100 * prof.guardband:.0f}%)")
    rows = []
    for v in SWEEP:
        out, stats = dom.read("weights", voltage=v)
        wrong = int((out.cpu().numpy() != weights).sum())
        print(
            f"V={v:.2f}: faulty_words={stats.faulty_words:5d} "
            f"corrected={stats.corrected:5d} detected={stats.detected:4d} "
            f"silent={stats.silent:3d} wrong_values={wrong:5d} "
            f"bram_power={voltage.bram_power(v, ecc=True):.3f} W"
        )
        rows.append({"v": v, "faulty_words": stats.faulty_words, "corrected": stats.corrected,
                     "detected": stats.detected, "silent": stats.silent, "wrong_values": wrong,
                     "bram_power_w": voltage.bram_power(v, ecc=True)})

    # 4. Runtime undervolting: lower until the first DED event, then lock.
    ctrl = UndervoltController(prof, step_v=0.01)
    while not ctrl.locked:
        dom.stats = FaultStats()
        _, stats = dom.read("weights", voltage=ctrl.voltage)
        ctrl.update(stats)
    saving = 1 - voltage.bram_power(ctrl.voltage, ecc=True) / voltage.bram_power(1.0)
    print(
        f"controller locked at {ctrl.voltage:.2f} V "
        f"({100 * saving:.1f}% "
        f"BRAM power saving vs nominal, zero uncorrected faults)"
    )
    return {"sweep": rows, "lock_v": ctrl.voltage, "saving": saving}


if __name__ == "__main__":
    main()
