#!/usr/bin/env python3
"""Prefill and decode times of the port's forward at serving lengths, for
an A/B of two checkouts on one card.

    PYTHONPATH=<checkout>/src python3 port_ab.py --label NAME [--out FILE] [--stream]

``repro_torch`` is imported from PYTHONPATH, so the same script times any
checkout of the port; run the checkouts interleaved on one card (A, B, B,
A) and compare only within that call. On an inline single-rail qwen3-0.6b
engine at nominal voltage (random weights from seed 0, every matrix read
through the fused ECC matmul), for each (batch, prompt length) it records:

  - prefill: wall time (synchronised, min of 2 after a warm-up) and the
    peak device memory the call allocated above what was allocated before
    it; a prefill the card cannot hold is recorded as out of memory;
  - decode: the median and min wall time of 8 decode steps after
    the prompt (a scalar position), after one warm-up step, and the number
    of PyTorch operations one decode step dispatches (the host's work;
    the hand-written kernels, launched through ctypes, are not counted).

It also times the fused ECC matmul alone (device time by CUDA events,
queued behind matmuls so the host's enqueue does not show): a layer's 7
matrices at M = 4 (decode), M = 20 (a speculative verify block) and M = 128
(prefill), each cycled through the
28 layers so the planes come from HBM, and the Fig. 3 MLP's three shapes
(784-256-128-10, random weights) at M = 4,000.

``--stream`` also serves the 8-request stream of ``chip_smoke.py`` phase 6
(0.56 V kv rail, 14 pages, 4 lanes) 8 times and records each run's wall
time; where the checkout's ``serve`` has a ``scrub_overlap`` option, the
runs alternate it on and off (on, off, off, on, ...).

One JSON object is printed on the last line and written to ``--out``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time

CASES = [(4, 32), (4, 512), (1, 2048), (4, 2048)]  # (batch, prompt); cache max(64, prompt + 16)
DECODE_STEPS = 8


def _op_counter():
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        """Counts the PyTorch operations dispatched inside the block."""

        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    return OpCount


def _time_b3(eng, cfg, dev) -> dict:
    """Device ms of ``ops.ecc_matmul``: per layer (its 7 matrices) at M = 4,
    20 and 128, and the MLP's 3 layers at M = 4,000."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import base

    busy = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)

    def queue(n):
        for _ in range(n):
            torch.mm(busy, busy)

    queue(10)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    queue(50)
    e.record()
    e.synchronize()
    mm_ms = s.elapsed_time(e) / 50

    def device_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        queue(int(50.0 / mm_ms) + 1)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters

    gen = torch.Generator(device=dev).manual_seed(1)
    leaves = [w for k, w in base.flatten(eng.params)
              if isinstance(w, ops.EccWeight) and ("attn" in k or "mlp" in k)]
    res = {}
    for m in (4, 20, 128):
        shapes = {}
        for w in leaves:
            layers = [w.layer(g) for g in range(cfg.n_groups)]
            x = torch.randn(m, w.k, generator=gen, device=dev)
            shapes[f"{w.k}x{w.n}"] = shapes.get(f"{w.k}x{w.n}", 0.0) + device_ms(
                lambda: [ops.ecc_matmul(x, lw) for lw in layers], 5) / len(layers)
        res[f"M={m}"] = {"per_layer_ms": sum(shapes.values()), "shapes_ms": shapes}
    mlp = [ops.pack_ecc_weights(torch.randn(k, n, generator=gen, device=dev))
           for k, n in ((784, 256), (256, 128), (128, 10))]
    xs = [torch.randn(4000, w.k, generator=gen, device=dev) for w in mlp]
    res["mlp_M=4000_ms"] = device_ms(lambda: [ops.ecc_matmul(x, w) for x, w in zip(xs, mlp)],
                                     20)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--out")
    ap.add_argument("--stream", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ReliabilityConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    OpCount = _op_counter()
    dev = torch.device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    cfg = get_config("qwen3-0.6b")
    params = lm.init_params(cfg, seed=0, device=dev)
    eng = ServingEngine(cfg, params, rel=ReliabilityConfig(mode="inline", voltage=1.0),
                        max_len=80)
    del params
    torch.cuda.synchronize()

    def wall_ms(fn) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    rng = np.random.default_rng(0)
    out = {"label": args.label, "gpu": gpu, "torch": torch.__version__, "cases": []}
    for b, s in CASES:
        row = {"batch": b, "prompt": s}
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)), device=dev)
        cache = lm.init_cache(cfg, b, max(64, s + 16), device=dev)
        try:
            logits, _ = lm.prefill(eng.params, toks, cfg, cache)
            del logits
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            row["prefill_ms"] = min(wall_ms(lambda: lm.prefill(eng.params, toks, cfg, cache))
                                    for _ in range(2))
            row["prefill_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
            tok = toks[:, -1:]
            steps = []
            for i in range(DECODE_STEPS + 1):
                steps.append(wall_ms(lambda: lm.decode_step(eng.params, tok, cfg, cache, s + i)))
            row["decode_ms_median"] = statistics.median(steps[1:])
            row["decode_ms_min"] = min(steps[1:])
            with OpCount() as ops:
                lm.decode_step(eng.params, tok, cfg, cache, s)
            row["decode_torch_ops"] = ops.n
        except torch.cuda.OutOfMemoryError as e:
            row["out_of_memory"] = str(e).splitlines()[0][:200]
        del cache
        torch.cuda.empty_cache()
        out["cases"].append(row)
        print(json.dumps(row), flush=True)

    out["b3"] = _time_b3(eng, cfg, dev)
    print(json.dumps(out["b3"]), flush=True)

    if args.stream:
        r = np.random.default_rng(1)
        stream = [(r.integers(0, cfg.vocab, int(r.integers(16, 49))).astype(np.int32),
                   int(r.integers(8, 25))) for _ in range(8)]
        runs = []
        eng.serve(stream, n_lanes=4, kv_voltage=0.56, n_pages=14)  # warm-up
        modes = (True, False, False, True) * 2
        if "scrub_overlap" not in inspect.signature(eng.serve).parameters:
            modes = (None,) * 8
        for overlap in modes:
            kw = {} if overlap is None else {"scrub_overlap": overlap}
            t = time.perf_counter()
            rep = eng.serve(stream, n_lanes=4, kv_voltage=0.56, n_pages=14, **kw)
            torch.cuda.synchronize()
            runs.append({"scrub_overlap": overlap, "wall_s": time.perf_counter() - t,
                         "tokens": sum(len(v) for v in rep.outputs.values()),
                         "intervals": len(rep.kv_voltages), "preemptions": rep.preemptions})
            print(json.dumps(runs[-1]), flush=True)
        out["stream"] = runs

    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
