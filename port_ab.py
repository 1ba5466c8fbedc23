#!/usr/bin/env python3
"""Prefill and decode times of the port's forward at serving lengths, for
an A/B of two checkouts on one card.

    PYTHONPATH=<checkout>/src python3 port_ab.py --label NAME [--out FILE] [--stream]
        [--b4] [--b2] [--b5] [--b6] [--b7] [--field]

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

``--b6`` times the paged scrub-on-read (B6, ``ops.gather_scrub_pages``) alone
instead, at its main-path shapes, by CUDA events around each call with the
faults restored and the L2 filled with clean lines before it (outside the
window), so every call scrubs the same faulty words from device memory:
the 40-id table of ``chip_smoke.py`` phase 2 (duplicate and scratch ids)
over a 64-page arena after one 0.54 V fault interval, under each codec
(and over the same arena before it, where no word has a fault),
and the serve stream's interval scrub (16 ids: 14 pages and two scratch
rows of a 14-page arena after three 0.56 V intervals) under secded72
(phase 6) and ileave88 (phase 9). Every arena row, the scratch row
included, is a codeword before the faults. It builds no model.

``--b4`` times the token commit (B4's commit form, ``ops.encode_commit``)
alone under each codec, by CUDA events over a window of calls queued behind
matmuls: 4 rows (a decode step), 20 rows (a speculative verify block) and
128 rows (a 4 x 32-token prompt) of qwen3-0.6b's 28,672-word tokens into a
64-page arena, with the time of a one-element in-place ``add_`` in the same
loop (the floor of one launch) beside it. ``--b2`` times the fused
inject+scrub (B1, ``ops.inject_scrub``) and its per-domain form (B2,
``ops.inject_scrub_domains``) alone under each codec at ``chip_smoke.py``'s
word counts (B1: the 55,050,240-word single-rail arena; B2: the
74,498,048-word multi-rail arena in three domain runs, and under parity65
and dected79 the attention and MLP groups of the per-domain-codec engine)
on random words and masks drawn on the card (each bit flips with
probability 2^-10). ``--b5`` times the decode (B5, ``ops.decode``) alone
under each codec at ``chip_smoke.py``'s word counts (secded72: the
19,447,808-word embedding; parity65 and dected79: the attention and MLP
groups of the per-domain-codec engine, 22,020,096 and 33,030,144 words;
ileave88: the 64-page KV arena, 14,680,064 words) on random codewords with
the faults of one 0.54 V draw of the device field
(``faultsim.interval_masks``), and records the status counts and whether the
planes are aligned for quad loads. ``--b7`` times the fault injection (B7, ``ops.inject``) and
the three ``torch.bitwise_xor`` calls that compute the same function, over
the 55,050,240-word single-rail arena and the Fig. 3 MLP's 29,344 words, on
random planes and masks drawn on the card. Both time each call by CUDA
events with the L2 filled with clean lines before it, as ``--b6`` does.
``--field`` times a KV fault interval's mask draw
(``faultsim.interval_masks`` at 0.56 V over the serve stream's 14-page
arena and its scratch page, 3,440,640 words, under secded72 and ileave88):
device ms by CUDA events and wall ms (synchronised, min of 5), whatever the
checkout draws it with; where the checkout has ``DeviceFaultField``, also
a 0.56 V draw of the 55,050,240-word single-rail arena's field, and
where it also has bursts, the avionics environment's burst field at its
scenario voltage (0.5924 V) over the arena (``DeviceFaultField(...,
burst=)``, secded72 and ileave88, beside the burst-free field at the same
voltage) and over the KV interval (``interval_masks(..., burst=)``). None
of these builds a model; ``--b4``, ``--b2``, ``--b5``, ``--b6``, ``--b7`` and
``--field`` may be given together and replace the model's timings.

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


def _device_queue(dev):
    """``queue()``: enqueues ~50 ms of large matmuls, so that the timed window
    queued behind it measures device time only (the host has enqueued the
    window's launches before the card reaches them)."""
    import torch

    busy = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)

    def mm(n):
        for _ in range(n):
            torch.mm(busy, busy)

    mm(10)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    mm(50)
    e.record()
    e.synchronize()
    mm_ms = s.elapsed_time(e) / 50
    return lambda: mm(int(50.0 / mm_ms) + 1)


def _window_ms(queue, fn, iters: int) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls
    queued behind ~50 ms of matmuls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    queue()
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def _cold_ms(queue, fn, iters: int, before=None) -> float:
    """Device ms per call of ``fn``: CUDA events around each of ``iters``
    calls, each after ``before()`` (if given) and a read of 128 MB that fills
    the L2 (50 MB) with clean lines, both outside its window; the calls
    queued behind ~50 ms of matmuls, after one warm-up call."""
    import torch

    l2_flush = torch.zeros(32 * 2**20, device="cuda")
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(iters)]
    queue()
    for s, e in evs:
        if before is not None:
            before()
        l2_flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / iters


def _time_b3(eng, cfg, dev) -> dict:
    """Device ms of ``ops.ecc_matmul``: per layer (its 7 matrices) at M = 4,
    20 and 128, and the MLP's 3 layers at M = 4,000."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import base

    queue = _device_queue(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    leaves = [w for k, w in base.flatten(eng.params)
              if isinstance(w, ops.EccWeight) and ("attn" in k or "mlp" in k)]
    res = {}
    for m in (4, 20, 128):
        shapes = {}
        for w in leaves:
            layers = [w.layer(g) for g in range(cfg.n_groups)]
            x = torch.randn(m, w.k, generator=gen, device=dev)
            shapes[f"{w.k}x{w.n}"] = shapes.get(f"{w.k}x{w.n}", 0.0) + _window_ms(
                queue, lambda: [ops.ecc_matmul(x, lw) for lw in layers], 5) / len(layers)
        res[f"M={m}"] = {"per_layer_ms": sum(shapes.values()), "shapes_ms": shapes}
    mlp = [ops.pack_ecc_weights(torch.randn(k, n, generator=gen, device=dev))
           for k, n in ((784, 256), (256, 128), (128, 10))]
    xs = [torch.randn(4000, w.k, generator=gen, device=dev) for w in mlp]
    res["mlp_M=4000_ms"] = _window_ms(
        queue, lambda: [ops.ecc_matmul(x, w) for x, w in zip(xs, mlp)], 20)
    return res


def _time_b6(dev, iters: int = 20) -> dict:
    """Device ms of ``ops.gather_scrub_pages`` per call, faults restored
    before each call (see ``--b6``), with the (clean, corrected, detected)
    counts of the timed words."""
    import numpy as np
    import torch

    from repro_torch import codes
    from repro_torch.configs import get_config
    from repro_torch.core.kvpages import KVGeometry, KVPageArena
    from repro_torch.core.voltage import PLATFORMS
    from repro_torch.kernels import ops

    queue = _device_queue(dev)
    geom = KVGeometry.from_config(get_config("qwen3-0.6b"))
    wpp = geom.words_per_page

    def faulty_arena(n_pages, codec, volts, intervals):
        """Random words, every row a codeword (the scratch row too, as in
        serving), then ``intervals`` fault intervals at ``volts``."""
        arena = KVPageArena(geom, PLATFORMS["vc707"], n_pages, seed=0, codec=codec, device=dev)
        g = torch.Generator(device=dev).manual_seed(2)
        word = lambda: torch.randint(-2**31, 2**31, arena.lo.shape, generator=g, device=dev,
                                     dtype=torch.int64).to(torch.int32)
        arena.lo, arena.hi = word(), word()
        arena.parity.copy_(ops.encode(arena.lo, arena.hi, codec=codec))
        arena.set_voltage(volts)
        for _ in range(intervals):
            arena.tick()
        return arena

    def row(arena, ids, codec):
        ids_d = torch.as_tensor(np.asarray(ids, np.int32), device=dev)
        saved = (arena.lo, arena.hi, arena.parity)
        work = [t.clone() for t in saved]
        counts = ops.gather_scrub_pages(*work, ids_d, wpp, codec=codec)[1][:, :3].sum(0).tolist()

        def restore():
            for w, t in zip(work, saved):
                w.copy_(t)

        ms = _cold_ms(queue, lambda: ops.gather_scrub_pages(*work, ids_d, wpp, codec=codec),
                      iters, restore)
        return {"ms": ms, "n_words": len(ids) * wpp, "counts": counts}

    res = {}
    table40 = np.concatenate([np.arange(0, 64, 2), [5, 5, 6, 6, 6, 64, 64, 0]])
    for codec in codes.names():
        # the same words before the interval: the cost of the faults is the difference
        for name, intervals in ((f"table40_{codec}_clean", 0), (f"table40_{codec}", 1)):
            res[name] = row(faulty_arena(64, codec, 0.54, intervals), table40, codec)
            print(json.dumps({name: res[name]}), flush=True)
    interval = np.concatenate([np.arange(14), [14, 14]])  # 14 pages, two scratch rows
    for codec in ("secded72", "ileave88"):
        # three intervals, as chip_smoke.py's stream breakdown ticks before its scrub
        res[f"interval_{codec}"] = row(faulty_arena(14, codec, 0.56, 3), interval, codec)
        print(json.dumps({f"interval_{codec}": res[f"interval_{codec}"]}), flush=True)
    return res


def _time_b4(dev, iters: int = 50) -> dict:
    """Device ms of ``ops.encode_commit`` per call (see ``--b4``)."""
    import numpy as np
    import torch

    from repro_torch import codes
    from repro_torch.configs import get_config
    from repro_torch.core.kvpages import KVGeometry, row_bases
    from repro_torch.kernels import ops

    queue = _device_queue(dev)
    geom = KVGeometry.from_config(get_config("qwen3-0.6b"))
    g = torch.Generator(device=dev).manual_seed(7)
    one = torch.zeros(1, device=dev)
    res = {"launch_floor_ms": _window_ms(queue, lambda: one.add_(1), iters)}
    n = 65 * geom.words_per_page  # 64 pages and the scratch row
    tables = {"rows4": (np.arange(4) * 3, np.arange(4) % 8),
              "rows20": (np.arange(20) // 8 * 2, np.arange(20) % 8),
              "prompt4x32": (np.arange(128) // 8, np.arange(128) % 8)}
    for codec in codes.names():
        c = codes.get(codec)
        planes = [torch.zeros(n, dtype=torch.int32, device=dev),
                  torch.zeros(n, dtype=torch.int32, device=dev),
                  torch.zeros(n, dtype=c.check_torch_dtype, device=dev)]
        for name, (pages, slots) in tables.items():
            base = torch.as_tensor(row_bases(pages, slots, geom), device=dev)
            payload = torch.randn(len(pages), geom.token_f32, generator=g, device=dev)
            ms = _window_ms(queue, lambda: ops.encode_commit(
                payload, base, geom.token_words, *planes, codec=codec), iters)
            res[f"{name}_{codec}"] = {"ms": ms, "rows": len(pages),
                                      "n_words": len(pages) * geom.token_words}
            print(json.dumps({f"{name}_{codec}": res[f"{name}_{codec}"]}), flush=True)
    return res


def _time_b2(dev, iters: int = 20) -> dict:
    """Device ms of ``ops.inject_scrub`` and ``ops.inject_scrub_domains`` per
    call (see ``--b2``)."""
    import torch

    from repro_torch import codes
    from repro_torch.kernels import ops

    queue = _device_queue(dev)
    g = torch.Generator(device=dev).manual_seed(8)

    def words(n):
        return torch.randint(-2**31, 2**31, (n,), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def sparse(n):
        w = words(n)
        for _ in range(9):
            w &= words(n)
        return w

    runs = {"attention": 22_020_096, "mlp": 33_030_144, "embedding": 19_447_808}
    single = 55_050_240
    res = {}
    for codec in codes.names():
        c = codes.get(codec)
        cases = [("inject_scrub", single, None)]
        if codec in ("parity65", "dected79"):  # the codec engine's attention / MLP group
            d = "attention" if codec == "parity65" else "mlp"
            cases.append(("inject_scrub_domains", runs[d], [(list(runs).index(d), runs[d])]))
        if codec in ("secded72", "ileave88"):  # the whole multi-rail arena
            cases.append(("inject_scrub_domains", sum(runs.values()),
                          list(enumerate(runs.values()))))
        for kernel, n, dom_runs in cases:
            lo, hi = words(n), words(n)
            chk = ops.encode(lo, hi, codec=codec)
            masks = (sparse(n), sparse(n),
                     (sparse(n) & ((1 << c.n_check) - 1)).to(c.check_torch_dtype))
            if dom_runs is None:
                fn = lambda: ops.inject_scrub(lo, hi, chk, *masks, codec=codec)
            else:
                dom = torch.cat([torch.full((k,), i, dtype=torch.int32, device=dev)
                                 for i, k in dom_runs])
                fn = lambda: ops.inject_scrub_domains(lo, hi, chk, *masks, dom, len(runs),
                                                      codec=codec)
            key = f"{kernel}_{codec}"
            res[key] = {"ms": _window_ms(queue, fn, iters), "n_words": n}
            print(json.dumps({key: res[key]}), flush=True)
            del lo, hi, chk, masks, fn
            torch.cuda.empty_cache()
    return res


def _time_b5(dev, iters: int = 20) -> dict:
    """Device ms of ``ops.decode`` per call (see ``--b5``)."""
    import torch

    from repro_torch import codes
    from repro_torch.core import faultsim
    from repro_torch.core.voltage import PLATFORMS
    from repro_torch.kernels import ops

    queue = _device_queue(dev)
    g = torch.Generator(device=dev).manual_seed(9)
    platform = PLATFORMS["vc707"]
    words = {"secded72": 19_447_808, "parity65": 22_020_096, "ileave88": 14_680_064,
             "dected79": 33_030_144}
    res = {}
    for codec in codes.names():
        c, n = codes.get(codec), words[codec]
        lo, hi = (torch.randint(-2**31, 2**31, (n,), generator=g, device=dev,
                                dtype=torch.int64).to(torch.int32) for _ in range(2))
        chk = ops.encode(lo, hi, codec=codec)
        mlo, mhi, mchk = faultsim.interval_masks(
            0, 0, n, platform.fault_rate(0.54), platform.row_sigma, c.n_check, device=dev)
        planes = (lo ^ mlo, hi ^ mhi, chk ^ mchk)
        del lo, hi, chk, mlo, mhi, mchk
        status = torch.bincount(ops.decode(*planes, codec=codec)[2], minlength=3).tolist()
        key = f"decode_{codec}"
        # the planes start where the change's decode takes its quad loop
        quads = all(t.data_ptr() % (4 * t.element_size()) == 0 for t in planes)
        res[key] = {"ms": _cold_ms(queue, lambda: ops.decode(*planes, codec=codec), iters),
                    "n_words": n, "status_counts": status, "aligned_for_quads": quads}
        print(json.dumps({key: res[key]}), flush=True)
        del planes
        torch.cuda.empty_cache()
    return res


def _time_b7(dev, iters: int = 20) -> dict:
    """Device ms of ``ops.inject`` and of three ``torch.bitwise_xor`` calls
    per call (see ``--b7``)."""
    import torch

    from repro_torch.kernels import ops

    queue = _device_queue(dev)
    g = torch.Generator(device=dev).manual_seed(10)

    def words(n):
        return torch.randint(-2**31, 2**31, (n,), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def sparse(n):
        w = words(n)
        for _ in range(9):
            w &= words(n)
        return w

    res = {}
    for name, n in (("arena", 55_050_240), ("mlp", 29_344)):
        planes = (words(n), words(n), (words(n) & 255).to(torch.uint8),
                  sparse(n), sparse(n), (sparse(n) & 255).to(torch.uint8))
        xor3 = lambda: [torch.bitwise_xor(a, m) for a, m in zip(planes[:3], planes[3:])]
        res[name] = {"n_words": n, "ms": _cold_ms(queue, lambda: ops.inject(*planes), iters),
                     "library_ms": _cold_ms(queue, xor3, iters)}
        print(json.dumps({f"inject_{name}": res[name]}), flush=True)
        del planes
        torch.cuda.empty_cache()
    return res


def _time_field(dev, iters: int = 20) -> dict:
    """Device and wall ms of the KV interval's mask draw and of the device
    field (see ``--field``)."""
    import torch

    from repro_torch.core import faultsim
    from repro_torch.core.voltage import PLATFORMS

    queue = _device_queue(dev)
    platform = PLATFORMS["vc707"]
    rate, sigma = platform.fault_rate(0.56), platform.row_sigma

    def wall_ms(fn) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    res = {}
    for codec, n_check in (("secded72", 8), ("ileave88", 24)):
        n = 15 * 229_376
        fn = lambda: faultsim.interval_masks(0, 1, n, rate, sigma, n_check, device=dev)
        key = f"interval_masks_{codec}"
        res[key] = {"n_words": n, "ms": _window_ms(queue, fn, iters),
                    "wall_ms": min(wall_ms(fn) for _ in range(5))}
        print(json.dumps({key: res[key]}), flush=True)
    if hasattr(faultsim, "DeviceFaultField"):
        field = faultsim.DeviceFaultField(platform, 55_050_240, seed=0)
        fn = lambda: field.masks(0.56)
        res["device_field_secded72"] = {"n_words": field.n_words,
                                        "ms": _window_ms(queue, fn, iters),
                                        "wall_ms": min(wall_ms(fn) for _ in range(5))}
        print(json.dumps({"device_field_secded72": res["device_field_secded72"]}), flush=True)
        del field
        torch.cuda.empty_cache()
    if hasattr(faultsim, "DeviceFaultField") and hasattr(faultsim, "BurstProfile"):
        from repro_torch.core import scenario

        avionics = scenario.ENVIRONMENTS["avionics"]
        prof = avionics.scale_profile(platform)
        sv = scenario.scenario_voltage(platform, avionics)
        for codec, n_check in (("secded72", 8), ("ileave88", 24)):
            for burst, key in ((avionics.burst, f"burst_field_{codec}"),
                               (None, f"burst_free_field_{codec}")):
                field = faultsim.DeviceFaultField(prof, 55_050_240, seed=0, n_check=n_check,
                                                  burst=burst)
                fn = lambda: field.masks(sv)
                res[key] = {"n_words": field.n_words, "voltage": sv,
                            "ms": _window_ms(queue, fn, iters)}
                print(json.dumps({key: res[key]}), flush=True)
                del field
                torch.cuda.empty_cache()
            n = 15 * 229_376
            fn = lambda: faultsim.interval_masks(0, 1, n, prof.fault_rate(sv), sigma, n_check,
                                                 device=dev, burst=avionics.burst)
            key = f"burst_interval_masks_{codec}"
            res[key] = {"n_words": n, "voltage": sv, "ms": _window_ms(queue, fn, iters)}
            print(json.dumps({key: res[key]}), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--out")
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--b4", action="store_true")
    ap.add_argument("--b2", action="store_true")
    ap.add_argument("--b5", action="store_true")
    ap.add_argument("--b6", action="store_true")
    ap.add_argument("--b7", action="store_true")
    ap.add_argument("--field", action="store_true")
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
    timers = {"b4": _time_b4, "b2": _time_b2, "b5": _time_b5, "b6": _time_b6, "b7": _time_b7,
              "field": _time_field}
    if any(getattr(args, k) for k in timers):
        out = {"label": args.label, "gpu": gpu, "torch": torch.__version__}
        out.update({k: f(dev) for k, f in timers.items() if getattr(args, k)})
        return _emit(out, args.out)
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

    return _emit(out, args.out)


def _emit(out: dict, path) -> int:
    line = json.dumps(out)
    if path:
        with open(path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
