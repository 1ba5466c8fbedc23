#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero without
them. Phases, each printed on its own line with its wall time:

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  2. hold every kernel against its plain PyTorch version on the card at the
     main path's shapes: the fused inject+scrub (single-rail arena at 0.56 V
     and 0.54 V, both re-encode settings) and its per-domain form
     (multi-rail arena) and the SECDED decode (faulty embedding) bit for bit,
     the fused decode+matmul at every qwen3-0.6b (K, N) within
     1e-4 * max|plain| (float32 sums run in another order) at M = batch
     (its decode kernel) and M = batch x prompt (its tiled kernel), the
     M = batch rows equal to the same rows of the M = batch x prompt call
     (one K-sum order in both kernels), and the
     per-domain form with out-of-range domain ids; the SECDED encode over
     the weight arena and a 64-page KV arena and in its token-commit form,
     and the paged scrub-on-read over that arena at 0.54 V with duplicated
     and scratch page ids, bit for bit; then every codec variant (parity65,
     ileave88, dected79) of the inject+scrub in both forms, the encode in
     both forms, the decode and the paged scrub, bit for bit: at the codec
     path's shapes (its three weight groups and the 55 M-word arena under
     dected79 at 0.56 V and 0.54 V with host masks, both re-encode
     settings; the decode over the parity65 and dected79 groups; a 64-page
     KV arena under each codec with duplicate and scratch page ids), and
     the variants no path runs (inject+scrub under parity65 and ileave88,
     its domain form and the decode under ileave88) on masks drawn on the
     card;
  3. the tiny config through the port on the card and on the CPU, SECDED
     and per-domain-codec engines: equal tokens and equal counters;
  4. the full-width qwen3-0.6b engine, single-rail: nominal generate,
     0.56 V generate, prefill and decode step wall times, DED-canary
     autotune from 0.62 V, power report;
  5. the same on a multi-rail engine (per-domain locks);
  6. paged SECDED KV serving (``ServingEngine.serve``) at full width on an
     inline single-rail engine: nominal paged serve against dense
     ``generate`` (equal tokens), a stream of 8 mixed requests at a 0.56 V
     kv rail in an arena small enough to preempt (corrections required),
     shared prefixes against private pages and speculative decoding
     against greedy (equal tokens); then a multi-rail engine walking its
     kv rail; and a breakdown of a stream's decode step, token commit,
     fault interval and scrub;
  7. the paper's Fig. 3 NN accelerator at full width (784-256-128-10, 600
     training steps on 20,000 synthetic-MNIST images, 4,000 test images):
     a rail sweep from V_nom and from V_min down to V_crash with ECC on and
     off (error, divergence from the clean predictions, coverage, power,
     BRAM saving), fused against naive reads, per-leaf against batched
     steps, and the fused matmul at the MLP's M = 4,000 (its rows 0-3 equal
     to an M = 4 call's);
  8. the per-leaf inline engine (``batched=False``) at 0.56 V against
     phase 4's batched engine (planes, counters, tokens), and a domain-mode
     engine at nominal (read-back bit for bit the params it wrote, tokens
     of the unprotected model) and at 0.56 V (every array and the counters
     held against B7 + B5's plain versions on the same masks);
  9. the per-domain-codec engine at full width (multi-rail, attention under
     parity65, MLP under dected79, embedding under secded72, KV pages under
     ileave88): nominal tokens equal to phase 5's SECDED engine, a 0.56 V
     step whose counters equal the plain versions' on the same masks, the
     DED-canary autotune from 0.62 V (per-domain locks, codecs and check
     bits of the power report), generate at the locks, paged serve equal to
     dense generate and an 8-request stream at a 0.56 V kv rail
     (corrections required); then a single-rail dected79 engine (one 0.56 V
     step, generate). Each rail step must launch the domain inject+scrub
     once per codec group (the single-rail engine: the inject+scrub once),
     each refresh the decode once per leaf under a codec other than SECDED
     and once for the embedding and the SECDED encode once per re-encoded
     leaf;
  4-9 each zero the kernel launch counts at the start of a path and read
     them at its end, and fail unless every voltage step launched its scrub
     kernel once (B1 single-rail, B2 and the embedding's B5 multi-rail,
     none of the other path's), every forward pass of the protected model
     launched the fused matmul once per protected matrix of each layer
     (7 x 28 = 196), every weight pack and token commit launched the
     encode once, every fault interval and prefix-hit admission launched
     the paged scrub once, every per-leaf step and every domain read
     launched the fault injection and the decode once per leaf, and the
     plain codec never ran on the card;
  10. one prefill and one decode step of paths 4-5 under torch.profiler
     (device busy time, idle share, fused-matmul time inside the step, which
     must come from the decode kernel in a decode step and the tiled kernel
     in a prefill), tokens/s, voltage-step times and one
     ``{"kernels": [...]}`` line with times, bounds and per-path launch
     counts. The fused matmul has two entries, one per kernel behind its
     one launcher: decode (``ecc_matmul_decode_kernel``, timed at M = batch)
     and prefill (``ecc_matmul_kernel``, timed at M = batch x prompt); its
     count is split between them by the forward passes of at most
     ``DECODE_MAX_M`` rows and the others; the codec-generic kernels have one
     entry per (kernel, codec), their launches counted per codec.

The last line is ``{"ok": true, "device": {...}}``; any failed check raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BATCH, PROMPT_LEN, NEW_TOKENS = 4, 32, 16
MATMUL_RTOL = 1e-4  # |kernel - plain| <= MATMUL_RTOL * max|plain|
PAGED_MAX_LEN, STREAM_PAGES, KV_PAGES = 80, 14, 64
MLP_TRAIN, MLP_TEST = 20000, 4000  # the Fig. 3 benchmark's split
# the per-domain-codec engine of phase 9 (embedding keeps secded72)
CODEC_MIX = {"attention": "parity65", "mlp": "dected79", "kv": "ileave88"}
POPC_PER_SM_CLK = 16  # Hopper's popc issue rate (CUDA guide throughput table)

T0 = time.perf_counter()


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        print(f"[phase] {self.name}: start at {self.t - T0:.1f} s", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            print(
                f"[phase] {self.name}: done in {time.perf_counter() - self.t:.2f} s "
                f"| {gpu_line()}",
                flush=True,
            )
        return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})", file=sys.stderr)
        return 2

    import dataclasses

    import numpy as np

    from repro_torch import codes
    from repro_torch.codes.base import Codec
    from repro_torch.configs import get_config, get_smoke_config, paper_nn, shapes
    from repro_torch.core import faultsim, kvpages, memory, quantize
    from repro_torch.core.kvpages import KVGeometry, KVPageArena
    from repro_torch.core.nn_accel import EccMLP
    from repro_torch.core.planestore import PlaneStore
    from repro_torch.core.telemetry import FaultStats
    from repro_torch.core.voltage import PLATFORMS, power_saving
    from repro_torch.data import mnist
    from repro_torch.kernels import backend, ops, ref
    from repro_torch.kernels import ecc_matmul as b3_kernel
    from repro_torch.models import base, lm
    from repro_torch.serving import steps as serve_steps
    from repro_torch.serving.engine import (
        FaultModelConfig, ProtectionConfig, RailsConfig, ReliabilityConfig, ServingEngine,
        protect_params_inline,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # B3's two kernels: decode forwards (M = BATCH) run the decode kernel,
    # prefill forwards (M = BATCH x PROMPT_LEN) the tiled one.
    require(BATCH <= b3_kernel.DECODE_MAX_M < BATCH * PROMPT_LEN, "B3 threshold vs shapes")
    b3_names = b3_kernel.GLOBAL_KERNELS
    print(f"device: {torch.cuda.get_device_name(0)} | {gpu_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # A queue of large matmuls ahead of a timed window keeps the card busy
    # (and at its working clock) while the host enqueues every launch of the
    # window, so the window measures device time only.
    busy = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    busy_out = torch.empty_like(busy)

    def preroll(n: int) -> None:
        for _ in range(n):
            torch.mm(busy, busy, out=busy_out)

    preroll(10)
    torch.cuda.synchronize()
    _s, _e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _s.record()
    preroll(50)
    _e.record()
    _e.synchronize()
    busy_mm_ms = _s.elapsed_time(_e) / 50

    def sync_ms(fn, iters: int, warmup: int = 1) -> float:
        """Device time per call (CUDA events), the window queued behind
        ~50 ms of matmuls (its launches must fit the launch queue)."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        preroll(int(50.0 / busy_mm_ms) + 1)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def wall_ms(fn) -> float:
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t_)

    def device_events(fn) -> list:
        """(name, start_us, end_us) of every device event (kernels, copies)
        that ``fn`` causes, from torch.profiler's CUDA activity trace."""
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        return [(e.name, e.time_range.start, e.time_range.end)
                for e in prof.events() if e.device_type == cuda]

    def busy_us(evs) -> float:
        """Length of the union of the events' intervals."""
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(evs, key=lambda t: t[1]):
            if e > end:
                total += e - max(s, end)
                end = e
        return total

    def step_breakdown(params_, fwd, walls=None) -> dict:
        """Without ``walls``: the wall time of one prefill and one decode
        step (best of 3). With them (these wall times): the device time
        inside one more such step, traced by torch.profiler: the fused ECC
        matmul kernels' time and launches, all device work, and the idle
        share of the wall time. A trace can slow the host work that
        follows it in the process, so every traced step runs after the
        timed paths. Counts the forward passes it runs into ``fwd``."""
        toks_ = torch.as_tensor(prompts, device=dev)
        cache = lm.init_cache(cfg, BATCH, 64)

        def pre():
            fwd["prefill"] += 1
            return lm.prefill(params_, toks_, cfg, cache)

        logits_, _ = pre()
        tok = torch.argmax(logits_, dim=-1)[:, None]

        def dec():
            fwd["decode"] += 1
            return lm.decode_step(params_, tok, cfg, cache, PROMPT_LEN)

        out = {}
        for name, f in (("prefill", pre), ("decode", dec)):
            if walls is None:
                out[name] = {"wall_ms": min(wall_ms(f) for _ in range(3))}
                continue
            wall = walls[name]["wall_ms"]
            evs = device_events(f)
            mm = {k: [e for e in evs if v in e[0]] for k, v in b3_names.items()}
            row = {"wall_ms": wall, "traced_device_events": len(evs)}
            if evs:
                row.update({
                    "device_busy_ms": busy_us(evs) / 1e3,
                    "device_idle_share": 1.0 - busy_us(evs) / 1e3 / wall,
                    "ecc_matmul_ms": sum(e - s for v in mm.values() for _, s, e in v) / 1e3,
                    "ecc_matmul_launches": sum(map(len, mm.values())),
                    "ecc_matmul_launches_by_kernel": {k: len(v) for k, v in mm.items()},
                })
                row["ecc_matmul_share"] = row["ecc_matmul_ms"] / wall
            out[name] = row
        return out

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def same_bits(a, b) -> bool:
        """Equal dtype, shape and bits (NaNs included)."""
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))

    class Tally:
        """While active, counts what a path does that must launch a kernel:
        weight packs and token commits (B4), fault intervals and prefix-hit
        admission scrubs (B6), forward passes of the protected model by kind
        (B3, 196 each) and those of at most DECODE_MAX_M rows (B3's decode
        kernel); and every call of the plain codec on a CUDA tensor, which
        must stay 0."""

        def __init__(self):
            self.n = dict(packs=0, commits=0, intervals=0, prefix_scrubs=0,
                          prefill=0, decode=0, decode_kernel=0, plain_on_card=0)
            self._undo = []

        def _wrap(self, obj, name, key):
            real = getattr(obj, name)

            def wrapped(*a, **kw):
                k = key(*a, **kw) if callable(key) else key
                for k_ in (k,) if isinstance(k, str) else k or ():
                    self.n[k_] = self.n.get(k_, 0) + 1
                return real(*a, **kw)

            setattr(obj, name, wrapped)
            self._undo.append((obj, name, real))

        def __enter__(self):
            on_card = lambda *a, **kw: "plain_on_card" if any(
                isinstance(t, torch.Tensor) and t.is_cuda for t in a) else None

            def kind(params, tokens, *a, **kw):
                if not isinstance(params["blocks"]["p0"]["attn"]["wq"], ops.EccWeight):
                    return None
                k = "decode" if tokens.shape[1] == 1 else "prefill"
                small = tokens.shape[0] * tokens.shape[1] <= b3_kernel.DECODE_MAX_M
                return (k, "decode_kernel") if small else k

            self._wrap(ops, "pack_ecc_weights", "packs")
            self._wrap(kvpages, "_commit_tokens", "commits")
            self._wrap(serve_steps, "_commit_tokens", "commits")
            self._wrap(KVPageArena, "tick", "intervals")
            self._wrap(KVPageArena, "scrub_pages", "prefix_scrubs")
            self._wrap(lm, "forward", kind)
            self._wrap(Codec, "encode", on_card)
            self._wrap(Codec, "decode", on_card)
            return self

        def __exit__(self, *exc):
            for obj, name, real in reversed(self._undo):
                setattr(obj, name, real)
            return False

        @contextlib.contextmanager
        def outside(self):
            """A check that is not part of the path (the plain versions on
            the card): what it counts is dropped."""
            saved = dict(self.n)
            yield
            self.n = saved

    # ---------------------------------------------------------------- 1
    with Phase("1 build kernels"):
        built = backend.build()
        for name in backend.SOURCES:
            print(f"  built {name}.cu in {built.get(name, 0.0):.1f} s -> "
                  f"{backend.library_path(name).name}")
            for line in backend.BUILD_LOG.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    ptxas {line.strip()}")

    cfg = get_config("qwen3-0.6b")
    platform = PLATFORMS["vc707"]
    report: dict = {}

    # ---------------------------------------------------------------- 2
    with Phase("2 kernels vs plain versions at main-path shapes"):
        params = lm.init_params(cfg, seed=0, device=dev)
        clean, _ = protect_params_inline(params, cfg)
        flat = base.flatten(clean)
        eccs = [(k, w) for k, w in flat if isinstance(w, ops.EccWeight)]
        store = PlaneStore([w for _, w in eccs], [k for k, _ in eccs], platform, device=dev)
        n = store.n_words
        print(f"  single-rail arena: {n} words in {len(eccs)} leaves")

        b1 = {"n_words": n}
        for v in (0.56, 0.54):
            t = time.perf_counter()
            masks = store.host_masks(v)
            mask_s = time.perf_counter() - t
            for reencode in (False, True):
                args = (store.lo, store.hi, store.parity, *masks)
                k_out = ops.inject_scrub(*args, reencode=reencode)
                p_out = ref.inject_scrub_ref(*args, reencode=reencode)
                torch.cuda.synchronize()
                require(same(k_out, p_out), f"inject_scrub differs at {v} V reencode={reencode}")
                print(f"  inject_scrub {v} V reencode={reencode}: bit-identical, "
                      f"counters {k_out[3].tolist()}, host masks {mask_s:.2f} s")
                if v == 0.56 and not reencode:
                    faulty = store._slice_leaves([k_out[:3]])
            if v == 0.56:
                b1["ms"] = sync_ms(lambda: ops.inject_scrub(*args), 20)
                b1["plain_ms"] = sync_ms(lambda: ref.inject_scrub_ref(*args), 3)
                b1["host_mask_s"] = mask_s
        b1["bound_ms"] = 1e3 * 27 * n / HBM_BYTES_PER_S
        report["inject_scrub"] = b1

        # Read-time fault injection (B7) at the 0.54 V draw over the whole
        # arena, then over the paper MLP's planes (784-256-128-10).
        def inject_row(args_, words, iters):
            require(same(ops.inject(*args_), ref.inject_ref(*args_)),
                    f"inject differs over {words} words")
            return {"n_words": words, "ms": sync_ms(lambda: ops.inject(*args_), iters),
                    "plain_ms": sync_ms(lambda: ref.inject_ref(*args_), 3),
                    "bound_ms": 1e3 * 27 * words / HBM_BYTES_PER_S}

        report["inject"] = inject_row((store.lo, store.hi, store.parity, *masks), n, 20)
        pcfg = paper_nn.config()
        mlp_store = EccMLP(pcfg.layer_sizes, platform=pcfg.platform, seed=0, device=dev)
        mlp_store.store()
        ms_ = mlp_store._store
        report["inject"]["mlp"] = inject_row(
            (ms_.lo, ms_.hi, ms_.parity, *ms_.host_masks(0.54)), ms_.n_words, 200)
        for r_ in (report["inject"], report["inject"]["mlp"]):
            print(f"  inject at 0.54 V over {r_['n_words']} words: bit-identical, "
                  f"{r_['ms']:.4f} ms, bound {r_['bound_ms']:.4f} ms (bytes), "
                  f"plain {r_['plain_ms']:.3f} ms")
        del mlp_store, ms_

        # SECDED encode (B4) over the whole weight arena: the check plane of
        # every weight pack, in one launch.
        require(same([ops.encode(store.lo, store.hi)], [ref.encode_ref(store.lo, store.hi)]),
                "encode differs on the weight arena")
        report["encode"] = {
            "n_words": n, "ms": sync_ms(lambda: ops.encode(store.lo, store.hi), 20),
            "plain_ms": sync_ms(lambda: ref.encode_ref(store.lo, store.hi), 2),
            "bound_ms": 1e3 * 9 * n / HBM_BYTES_PER_S,
        }
        print(f"  encode over the weight arena ({n} words): bit-identical, "
              f"{report['encode']['ms']:.3f} ms, bound {report['encode']['bound_ms']:.3f} ms, "
              f"plain {report['encode']['plain_ms']:.2f} ms")

        # Fused decode+matmul on the faulty 0.56 V planes of layer 0.
        by_key = dict(zip((k for k, _ in eccs), faulty))
        names = ("wq", "wk", "wv", "wo")
        mm_keys = [f"['blocks']['p0']['attn'][{w!r}]" for w in names] + [
            f"['blocks']['p0']['mlp'][{w!r}]" for w in ("w1", "w3", "w2")
        ]
        # One entry per M, its times summed over the seven matmuls of a layer:
        # M = BATCH runs the decode kernel, M = BATCH x PROMPT_LEN the tiled
        # one, and the decode kernel's rows must equal the tiled kernel's.
        b3 = {m: {"M": m, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                  "library_ms": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0, "shapes": [],
                  "function": b3_names["decode" if m <= b3_kernel.DECODE_MAX_M else "tiled"]}
              for m in (BATCH, BATCH * PROMPT_LEN)}
        gen = torch.Generator(device=dev).manual_seed(1)
        for key in (k for k in mm_keys if k in by_key):
            ew = by_key[key]
            layers_ = [ew.layer(g) for g in range(cfg.n_groups)]
            w_deq = [ref.ecc_matmul_ref(torch.eye(ew.k, device=dev), lw.lo, lw.hi,
                                        lw.parity, lw.scale) for lw in layers_[:2]]
            x_all = torch.randn(BATCH * PROMPT_LEN, ew.k, generator=gen, device=dev)
            for lw in layers_[:2]:
                require(torch.equal(ops.ecc_matmul(x_all[:BATCH], lw),
                                    ops.ecc_matmul(x_all, lw)[:BATCH]),
                        f"ecc_matmul {key}: the M={BATCH} rows differ from the same rows at "
                        f"M={BATCH * PROMPT_LEN}")
            for m in (BATCH, BATCH * PROMPT_LEN):
                x = x_all[:m]
                worst = 0.0
                for lw in layers_[:2]:
                    k_o = ops.ecc_matmul(x, lw)
                    p_o = ref.ecc_matmul_ref(x, lw.lo, lw.hi, lw.parity, lw.scale)
                    torch.cuda.synchronize()
                    err = float((k_o - p_o).abs().max())
                    scale = float(p_o.abs().max())
                    require(bool(torch.isfinite(k_o).all()), f"ecc_matmul non-finite {key}")
                    require(err <= MATMUL_RTOL * scale,
                            f"ecc_matmul {key} M={m}: err {err} > {MATMUL_RTOL} * {scale}")
                    worst = max(worst, err)
                    b3[m]["max_rel_err"] = max(b3[m]["max_rel_err"], err / scale)
                # Cycle through all layers so the planes come from HBM, as in
                # the decode loop (28 layers of planes exceed the 50 MB L2).
                ms = sync_ms(lambda: [ops.ecc_matmul(x, lw) for lw in layers_], 5) / len(layers_)
                pms = sync_ms(lambda: [ref.ecc_matmul_ref(x, lw.lo, lw.hi, lw.parity, lw.scale)
                                       for lw in layers_[:4]], 2) / 4
                lib = sync_ms(lambda: [torch.matmul(x, w) for w in w_deq], 20) / len(w_deq)
                k, nn = ew.k, ew.n
                nbytes = 4 * m * k + 9 * k * nn // 8 + 4 * nn + 4 * m * nn
                bt, ot = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * 2 * m * k * nn / FP32_FLOPS
                row = {"key": key, "M": m, "K": k, "N": nn, "ms": ms, "plain_ms": pms,
                       "library_ms": lib, "bound_ms": max(bt, ot),
                       "bound_by": "bytes" if bt >= ot else "operations",
                       "max_abs_err": worst}
                b3[m]["shapes"].append(row)
                for f in ("ms", "plain_ms", "library_ms"):
                    b3[m][f] += row[f]
                b3[m]["bytes_ms"] += bt
                b3[m]["ops_ms"] += ot
                b3[m]["max_abs_err"] = max(b3[m]["max_abs_err"], worst)
                print(f"  ecc_matmul M={m} K={k} N={nn} ({b3[m]['function']}): max err "
                      f"{worst:.3e} (<= {MATMUL_RTOL}*max|plain|), {ms:.4f} ms, bound "
                      f"{max(bt, ot):.4f} ms ({row['bound_by']}), plain {pms:.4f} ms, "
                      f"torch.matmul {lib:.4f} ms")
        print(f"  ecc_matmul rows: the M={BATCH} rows of {b3_names['decode']} equal the same "
              f"rows of {b3_names['tiled']} at M={BATCH * PROMPT_LEN}, every layer shape")
        for r in b3.values():
            r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
            r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
            print(f"  ecc_matmul M={r['M']} ({r['function']}), a layer's 7 matmuls: "
                  f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} ms")
        report["ecc_matmul_decode"] = b3[BATCH]
        report["ecc_matmul_prefill"] = b3[BATCH * PROMPT_LEN]
        del store, faulty, by_key, masks, args, k_out, p_out, w_deq, layers_
        torch.cuda.empty_cache()

        # Multi-rail arena (embedding protected as its own domain).
        clean, _ = protect_params_inline(params, cfg, include_embed=True)
        eccs = [(k, w) for k, w in base.flatten(clean) if isinstance(w, ops.EccWeight)]
        mstore = PlaneStore([w for _, w in eccs], [k for k, _ in eccs], platform,
                            domain_key=shapes.domain_of, device=dev)
        n = mstore.n_words
        volts = {"attention": 0.56, "mlp": 0.55, "embedding": 0.54}
        t = time.perf_counter()
        masks = mstore.host_masks(volts)
        mask_s = time.perf_counter() - t
        args = (mstore.lo, mstore.hi, mstore.parity, *masks, mstore.dom_ids, len(mstore.domains))
        k_out = ops.inject_scrub_domains(*args)
        p_out = ref.inject_scrub_domains_ref(*args)
        torch.cuda.synchronize()
        require(same(k_out, p_out), "inject_scrub_domains differs")
        print(f"  inject_scrub_domains {volts}: bit-identical over {n} words, rows "
              f"{dict(zip(mstore.domains, k_out[3].tolist()))}, host masks {mask_s:.2f} s")
        # Domain ids outside [0, n_domains) between in-range runs count in
        # no row; the kernel must match the plain version there too.
        n_small = 1 << 20
        small = [a[:n_small] for a in args[:6]]
        odd = torch.tensor([0, -1, 1, 5, 2, 3, 1], device=dev, dtype=torch.int32)
        odd_ids = odd.repeat_interleave(n_small // len(odd) + 1)[:n_small].contiguous()
        k_odd = ops.inject_scrub_domains(*small, odd_ids, len(mstore.domains))
        p_odd = ref.inject_scrub_domains_ref(*small, odd_ids, len(mstore.domains))
        torch.cuda.synchronize()
        require(same(k_odd, p_odd), "inject_scrub_domains differs with out-of-range ids")
        print(f"  inject_scrub_domains with ids {odd.tolist()} over {n_small} words: "
              f"bit-identical, rows {k_odd[3].tolist()}")
        report["inject_scrub_domains"] = {
            "n_words": n, "host_mask_s": mask_s,
            "ms": sync_ms(lambda: ops.inject_scrub_domains(*args), 20),
            "plain_ms": sync_ms(lambda: ref.inject_scrub_domains_ref(*args), 3),
            "bound_ms": 1e3 * 31 * n / HBM_BYTES_PER_S,
        }
        emb = mstore._slice_leaves([k_out[:3]])[-1]
        require(mstore.slots[-1].key == "['embed']", mstore.slots[-1].key)
        e_args = (emb.lo, emb.hi, emb.parity)
        k_dec, p_dec = ops.decode(*e_args), ref.decode_ref(*(a.reshape(-1) for a in e_args))
        torch.cuda.synchronize()
        require(same([t_.reshape(-1) for t_ in k_dec], p_dec), "decode differs")
        st = torch.bincount(k_dec[2].reshape(-1), minlength=3).tolist()
        print(f"  decode embedding at 0.54 V: bit-identical over {emb.lo.numel()} words, "
              f"status counts {st}")
        ne = emb.lo.numel()
        report["decode"] = {
            "n_words": ne,
            "ms": sync_ms(lambda: ops.decode(*e_args), 50),
            "plain_ms": sync_ms(lambda: ref.decode_ref(*e_args), 3),
            "bound_ms": 1e3 * 21 * ne / HBM_BYTES_PER_S,
        }
        del mstore, masks, args, k_out, p_out, emb, e_args, k_dec, p_dec, clean, eccs
        del small, odd_ids, k_odd, p_odd
        torch.cuda.empty_cache()

        # A 64-page KV arena at full width: random words, encoded by B4, one
        # 0.54 V fault interval of the device field, then B6 over a table
        # with duplicated ids (a faulty page among them) and scratch ids.
        geom = KVGeometry.from_config(cfg)
        arena = KVPageArena(geom, platform, KV_PAGES, seed=0, device=dev)
        g = torch.Generator(device=dev).manual_seed(2)
        word = lambda: torch.randint(-2**31, 2**31, arena.lo.shape, generator=g, device=dev,
                                     dtype=torch.int64).to(torch.int32)
        arena.lo, arena.hi = word(), word()
        nk = arena.n_words
        real_lo, real_hi = arena.lo[:nk], arena.hi[:nk]
        k_enc = ops.encode(real_lo, real_hi)
        require(torch.equal(k_enc, ref.encode_ref(real_lo, real_hi)), "encode differs on the KV arena")
        arena.parity[:nk] = k_enc
        arena.set_voltage(0.54)
        arena.tick()
        ids = np.concatenate([np.arange(0, KV_PAGES, 2), [5, 5, 6, 6, 6, KV_PAGES, KV_PAGES, 0]])
        ids_d = torch.as_tensor(ids.astype(np.int32), device=dev)
        wpp = geom.words_per_page
        k_pl = [t.clone() for t in (arena.lo, arena.hi, arena.parity)]
        p_pl = [t.clone() for t in (arena.lo, arena.hi, arena.parity)]
        k_gs = ops.gather_scrub_pages(*k_pl, ids_d, wpp)
        p_gs = ref.gather_scrub_ref(*p_pl, ids_d, wpp)
        torch.cuda.synchronize()
        require(torch.equal(k_gs[0].view(torch.int32), p_gs[0].view(torch.int32))
                and torch.equal(k_gs[1], p_gs[1]), "gather_scrub payload or counters differ")
        require(same(k_pl, p_pl), "gather_scrub write-back differs")
        cnt = k_gs[1].sum(dim=0).tolist()
        require(cnt[1] > 0 and cnt[2] > 0, f"no corrected or detected words at 0.54 V: {cnt}")
        print(f"  gather_scrub over {len(ids)} page ids ({len(ids) * wpp} words, ids {ids.tolist()}) "
              f"of a {KV_PAGES}-page arena ({nk} words) at 0.54 V: bit-identical, "
              f"(clean, corrected, detected) = {cnt[:3]}")
        payload = torch.randn(BATCH, geom.token_f32, generator=g, device=dev)
        commit_base = torch.as_tensor(
            kvpages.row_bases(np.arange(BATCH) * 3, np.arange(BATCH) % 8, geom), device=dev)
        ops.encode_commit(payload, commit_base, geom.token_words, *k_pl)
        ref.encode_commit_ref(payload, commit_base, geom.token_words, *p_pl)
        torch.cuda.synchronize()
        require(same(k_pl, p_pl), "encode_commit differs")
        print(f"  encode over the KV arena ({nk} words) and a {BATCH}-token commit: bit-identical")
        rows = len(ids) * wpp
        report["gather_scrub"] = {
            "n_words": rows, "arena_words": nk, "page_ids": ids.tolist(),
            "ms": sync_ms(lambda: ops.gather_scrub_pages(*k_pl, ids_d, wpp), 20),
            "plain_ms": sync_ms(lambda: ref.gather_scrub_ref(*p_pl, ids_d, wpp), 2),
            "bound_ms": 1e3 * 26 * rows / HBM_BYTES_PER_S,
        }
        report["encode_kv_arena"] = {
            "n_words": nk, "ms": sync_ms(lambda: ops.encode(real_lo, real_hi), 20),
            "plain_ms": sync_ms(lambda: ref.encode_ref(real_lo, real_hi), 2),
            "bound_ms": 1e3 * 9 * nk / HBM_BYTES_PER_S,
        }
        cw = BATCH * geom.token_words
        report["encode_commit"] = {
            "n_words": cw, "rows": BATCH,
            "ms": sync_ms(lambda: ops.encode_commit(payload, commit_base, geom.token_words,
                                                    *k_pl), 50),
            "plain_ms": sync_ms(lambda: ref.encode_commit_ref(payload, commit_base,
                                                              geom.token_words, *p_pl), 5),
            "bound_ms": 1e3 * 17 * cw / HBM_BYTES_PER_S,
        }
        for key in ("gather_scrub", "encode_kv_arena", "encode_commit"):
            r = report[key]
            print(f"  {key} ({r['n_words']} words): {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"(bytes), plain {r['plain_ms']:.3f} ms")
        del arena, k_pl, p_pl, k_gs, p_gs, real_lo, real_hi, k_enc
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 2, codecs
    with Phase("2 codec variants vs plain versions"):
        sm_clock_hz = 1e6 * float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
        popc_per_s = (POPC_PER_SM_CLK * torch.cuda.get_device_properties(0).multi_processor_count
                      * sm_clock_hz)
        print(f"  popc rate {popc_per_s:.3e}/s ({POPC_PER_SM_CLK} per SM per clock at "
              f"{sm_clock_hz / 1e6:.0f} MHz max SM clock)")

        def bounds(words, codec, b_u8, b_u32, popc_extra=0, encodes=1):
            """Bytes (``b_u8`` or ``b_u32`` per word by the check plane's
            width) and popc (one per check bit per encode, plus
            ``popc_extra``) over this card's rates; the larger bounds."""
            c = codes.get(codec)
            bpw = b_u8 if c.n_check <= 8 else b_u32
            bt = 1e3 * bpw * words / HBM_BYTES_PER_S
            ot = 1e3 * (encodes * c.n_check + popc_extra) * words / popc_per_s
            return {"n_words": words, "codec": codec, "bytes_per_word": bpw, "bytes_ms": bt,
                    "ops_ms": ot, "bound_ms": max(bt, ot),
                    "bound_by": "bytes" if bt >= ot else "operations"}

        def timed(row, k_fn, p_fn, iters, p_iters=2):
            row["ms"] = sync_ms(k_fn, iters)
            row["plain_ms"] = sync_ms(p_fn, p_iters)
            print(f"  {row['name']} ({row['n_words']} words): bit-identical, {row['ms']:.4f} ms, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; bytes "
                  f"{row['bytes_ms']:.4f}, popc {row['ops_ms']:.4f}), plain {row['plain_ms']:.3f} ms")
            report[row["name"]] = row
            return row

        cg = torch.Generator(device=dev).manual_seed(3)

        def rand_words(n):
            return torch.randint(-2**31, 2**31, (n,), generator=cg, device=dev,
                                 dtype=torch.int64).to(torch.int32)

        def card_masks(n, codec):
            """Flip masks drawn on the card (each bit flips with probability
            2^-10: the AND of ten random words), for variants that no path
            runs; the check mask in the codec's dtype."""
            c = codes.get(codec)

            def sparse():
                w = rand_words(n)
                for _ in range(9):
                    w &= rand_words(n)
                return w

            chk = sparse() & ((1 << c.n_check) - 1)
            return sparse(), sparse(), chk.to(c.check_torch_dtype)

        # a. the codec engine's three weight groups (phase 9's arena)
        clean, _ = protect_params_inline(params, cfg, include_embed=True)
        eccs = [(k, w) for k, w in base.flatten(clean) if isinstance(w, ops.EccWeight)]
        cstore = PlaneStore([w for _, w in eccs], [k for k, _ in eccs], platform,
                            domain_key=shapes.domain_of, codecs=shapes.domain_codecs(CODEC_MIX),
                            device=dev)
        del clean, eccs
        nd = len(cstore.domains)
        print(f"  codec arena: {cstore.n_words} words, groups "
              f"{[(g.name, g.n_words) for g in cstore.groups]}")
        for g in cstore.groups:
            require(torch.equal(g.check, ref.encode_ref(g.lo, g.hi, g.name)),
                    f"encode differs on the {g.name} group")
            if g.name != "secded72":
                timed({"name": f"encode_{g.name}", **bounds(g.n_words, g.name, 9, 12)},
                      lambda g=g: ops.encode(g.lo, g.hi, codec=g.name),
                      lambda g=g: ref.encode_ref(g.lo, g.hi, g.name), 20)
        faulty_groups = {}
        for v in (0.56, 0.54):
            t = time.perf_counter()
            gm = cstore.group_host_masks(v)
            mask_s = time.perf_counter() - t
            for g, m in zip(cstore.groups, gm):
                for reencode in (True, False):
                    args = (g.lo, g.hi, g.check, *m, g.dom_ids, nd)
                    k_out = ops.inject_scrub_domains(*args, codec=g.name, reencode=reencode)
                    p_out = ref.inject_scrub_domains_ref(*args, codec=g.name, reencode=reencode)
                    torch.cuda.synchronize()
                    require(same(k_out, p_out),
                            f"inject_scrub_domains {g.name} differs at {v} V reencode={reencode}")
                print(f"  inject_scrub_domains {g.name} at {v} V ({g.n_words} words, host masks "
                      f"of all groups {mask_s:.2f} s): bit-identical with and without re-encode, "
                      f"rows {dict(zip(cstore.domains, k_out[3].tolist()))}")
                if v == 0.56:
                    faulty_groups[g.name] = k_out[:3]
                    if g.name != "secded72":
                        timed({"name": f"inject_scrub_domains_{g.name}", "host_mask_s": mask_s,
                               **bounds(g.n_words, g.name, 31, 40, popc_extra=3)},
                              lambda g=g, m=m: ops.inject_scrub_domains(
                                  g.lo, g.hi, g.check, *m, g.dom_ids, nd, codec=g.name),
                              lambda g=g, m=m: ref.inject_scrub_domains_ref(
                                  g.lo, g.hi, g.check, *m, g.dom_ids, nd, codec=g.name), 20)
            del gm
        # the refresh's decode over the faulty parity65 and dected79 leaves
        for name in ("parity65", "dected79"):
            planes = faulty_groups[name]
            k_dec, p_dec = ops.decode(*planes, codec=name), ref.decode_ref(*planes, codec=name)
            torch.cuda.synchronize()
            require(same(k_dec, p_dec), f"decode {name} differs")
            print(f"  decode {name} at 0.56 V: status counts "
                  f"{torch.bincount(k_dec[2], minlength=3).tolist()}")
            timed({"name": f"decode_{name}", **bounds(planes[0].numel(), name, 21, 24)},
                  lambda p_=planes, c_=name: ops.decode(*p_, codec=c_),
                  lambda p_=planes, c_=name: ref.decode_ref(*p_, codec=c_), 20)
        # no path: the domain form under ileave88 over the whole arena
        ichk = ops.encode(cstore.lo, cstore.hi, codec="ileave88")
        require(torch.equal(ichk, ref.encode_ref(cstore.lo, cstore.hi, "ileave88")),
                "encode ileave88 differs on the weight arena")
        im = card_masks(cstore.n_words, "ileave88")
        for reencode in (False, True):
            args = (cstore.lo, cstore.hi, ichk, *im, cstore.dom_ids, nd)
            require(same(ops.inject_scrub_domains(*args, codec="ileave88", reencode=reencode),
                         ref.inject_scrub_domains_ref(*args, codec="ileave88",
                                                      reencode=reencode)),
                    f"inject_scrub_domains ileave88 differs reencode={reencode}")
        args = (cstore.lo, cstore.hi, ichk, *im, cstore.dom_ids, nd)
        timed({"name": "inject_scrub_domains_ileave88", "masks": "card",
               **bounds(cstore.n_words, "ileave88", 31, 40, popc_extra=3)},
              lambda: ops.inject_scrub_domains(*args, codec="ileave88"),
              lambda: ref.inject_scrub_domains_ref(*args, codec="ileave88"), 20)
        del cstore, faulty_groups, planes, k_dec, p_dec, ichk, im, args, k_out, p_out
        torch.cuda.empty_cache()

        # b. the single-rail arena under dected79 (phase 9's second engine),
        # then the inject+scrub under parity65 and ileave88 (no path) over it
        clean, _ = protect_params_inline(params, cfg)
        eccs = [(k, w) for k, w in base.flatten(clean) if isinstance(w, ops.EccWeight)]
        dstore = PlaneStore([w for _, w in eccs], [k for k, _ in eccs], platform,
                            codecs="dected79", device=dev)
        del clean, eccs
        (g,) = dstore.groups
        n = g.n_words
        require(torch.equal(g.check, ref.encode_ref(g.lo, g.hi, "dected79")),
                "encode dected79 differs on the single-rail arena")
        for v in (0.56, 0.54):
            t = time.perf_counter()
            m = dstore.group_host_masks(v)[0]
            mask_s = time.perf_counter() - t
            for reencode in (False, True):
                k_out = ops.inject_scrub(g.lo, g.hi, g.check, *m, codec="dected79",
                                         reencode=reencode)
                p_out = ref.inject_scrub_ref(g.lo, g.hi, g.check, *m, codec="dected79",
                                             reencode=reencode)
                torch.cuda.synchronize()
                require(same(k_out, p_out), f"inject_scrub dected79 differs at {v} V "
                                            f"reencode={reencode}")
                print(f"  inject_scrub dected79 {v} V reencode={reencode} ({n} words): "
                      f"bit-identical, counters {k_out[3].tolist()}, host masks {mask_s:.2f} s")
            if v == 0.56:
                timed({"name": "inject_scrub_dected79", "host_mask_s": mask_s,
                       **bounds(n, "dected79", 27, 36, popc_extra=3)},
                      lambda m=m: ops.inject_scrub(g.lo, g.hi, g.check, *m, codec="dected79"),
                      lambda m=m: ref.inject_scrub_ref(g.lo, g.hi, g.check, *m,
                                                       codec="dected79"), 20)
            if v == 0.54:  # dected79's tables are read only where the syndrome is not 0
                zm = dstore.group_host_masks(1.0)[0]
                report["inject_scrub_dected79"]["ms_054"] = sync_ms(
                    lambda m=m: ops.inject_scrub(g.lo, g.hi, g.check, *m, codec="dected79"), 20)
                report["inject_scrub_dected79"]["ms_nominal"] = sync_ms(
                    lambda: ops.inject_scrub(g.lo, g.hi, g.check, *zm, codec="dected79"), 20)
                del zm
                print(f"  inject_scrub dected79: {report['inject_scrub_dected79']['ms_054']:.4f} "
                      f"ms at 0.54 V, {report['inject_scrub_dected79']['ms_nominal']:.4f} ms at "
                      "nominal (zero masks)")
            del m
        for name in ("parity65", "ileave88"):
            chk = ops.encode(g.lo, g.hi, codec=name)
            require(torch.equal(chk, ref.encode_ref(g.lo, g.hi, name)),
                    f"encode {name} differs on the single-rail arena")
            m = card_masks(n, name)
            for reencode in (False, True):
                args = (g.lo, g.hi, chk, *m)
                require(same(ops.inject_scrub(*args, codec=name, reencode=reencode),
                             ref.inject_scrub_ref(*args, codec=name, reencode=reencode)),
                        f"inject_scrub {name} differs reencode={reencode}")
            args = (g.lo, g.hi, chk, *m)
            timed({"name": f"inject_scrub_{name}", "masks": "card",
                   **bounds(n, name, 27, 36, popc_extra=3)},
                  lambda a_=args, c_=name: ops.inject_scrub(*a_, codec=c_),
                  lambda a_=args, c_=name: ref.inject_scrub_ref(*a_, codec=c_), 20)
            del chk, m, args
        del dstore, g, k_out, p_out
        torch.cuda.empty_cache()

        # c. a 64-page KV arena under each other codec: encode, one 0.54 V
        # fault interval, the decode, the paged scrub over duplicate and
        # scratch ids, and a token commit
        geom = KVGeometry.from_config(cfg)
        wpp = geom.words_per_page
        ids = np.concatenate([np.arange(0, KV_PAGES, 2), [5, 5, 6, 6, 6, KV_PAGES, KV_PAGES, 0]])
        ids_d = torch.as_tensor(ids.astype(np.int32), device=dev)
        for name in ("parity65", "ileave88", "dected79"):
            arena = KVPageArena(geom, platform, KV_PAGES, seed=0, codec=name, device=dev)
            arena.lo, arena.hi = rand_words(arena.lo.numel()), rand_words(arena.lo.numel())
            nk = arena.n_words
            real_lo, real_hi = arena.lo[:nk], arena.hi[:nk]
            k_enc = ops.encode(real_lo, real_hi, codec=name)
            require(torch.equal(k_enc, ref.encode_ref(real_lo, real_hi, name)),
                    f"encode {name} differs on the KV arena")
            arena.parity[:nk] = k_enc
            if name == "ileave88":
                timed({"name": "encode_ileave88", **bounds(nk, name, 9, 12)},
                      lambda: ops.encode(real_lo, real_hi, codec="ileave88"),
                      lambda: ref.encode_ref(real_lo, real_hi, "ileave88"), 20)
            arena.set_voltage(0.54)
            arena.tick()
            fplanes = (arena.lo[:nk], arena.hi[:nk], arena.parity[:nk])
            k_dec, p_dec = ops.decode(*fplanes, codec=name), ref.decode_ref(*fplanes, codec=name)
            torch.cuda.synchronize()
            require(same(k_dec, p_dec), f"decode {name} differs on the KV arena")
            if name == "ileave88":
                timed({"name": "decode_ileave88", **bounds(nk, name, 21, 24)},
                      lambda: ops.decode(*fplanes, codec="ileave88"),
                      lambda: ref.decode_ref(*fplanes, codec="ileave88"), 20)
            k_pl = [t.clone() for t in (arena.lo, arena.hi, arena.parity)]
            p_pl = [t.clone() for t in (arena.lo, arena.hi, arena.parity)]
            k_gs = ops.gather_scrub_pages(*k_pl, ids_d, wpp, codec=name)
            p_gs = ref.gather_scrub_ref(*p_pl, ids_d, wpp, codec=name)
            torch.cuda.synchronize()
            require(torch.equal(k_gs[0].view(torch.int32), p_gs[0].view(torch.int32))
                    and torch.equal(k_gs[1], p_gs[1]), f"gather_scrub {name} differs")
            require(same(k_pl, p_pl), f"gather_scrub {name} write-back differs")
            cnt = k_gs[1].sum(dim=0).tolist()
            require(cnt[2] > 0 and (cnt[1] > 0) == (name != "parity65"),
                    f"gather_scrub {name} at 0.54 V: {cnt}")
            print(f"  {name} KV arena ({nk} words) at 0.54 V: encode, decode (status "
                  f"{torch.bincount(k_dec[2], minlength=3).tolist()}) and gather_scrub over "
                  f"{len(ids)} page ids bit-identical, (clean, corrected, detected) = {cnt[:3]}")
            rows = len(ids) * wpp
            timed({"name": f"gather_scrub_{name}", **bounds(rows, name, 26, 32, encodes=2)},
                  lambda c_=name: ops.gather_scrub_pages(*k_pl, ids_d, wpp, codec=c_),
                  lambda c_=name: ref.gather_scrub_ref(*p_pl, ids_d, wpp, codec=c_), 20)
            payload = torch.randn(BATCH, geom.token_f32, generator=cg, device=dev)
            commit_base = torch.as_tensor(
                kvpages.row_bases(np.arange(BATCH) * 3, np.arange(BATCH) % 8, geom), device=dev)
            ops.encode_commit(payload, commit_base, geom.token_words, *k_pl, codec=name)
            ref.encode_commit_ref(payload, commit_base, geom.token_words, *p_pl, codec=name)
            torch.cuda.synchronize()
            require(same(k_pl, p_pl), f"encode_commit {name} differs")
            timed({"name": f"encode_commit_{name}", "rows": BATCH,
                   **bounds(BATCH * geom.token_words, name, 17, 20)},
                  lambda c_=name: ops.encode_commit(payload, commit_base, geom.token_words,
                                                    *k_pl, codec=c_),
                  lambda c_=name: ref.encode_commit_ref(payload, commit_base, geom.token_words,
                                                        *p_pl, codec=c_), 50, 5)
            del arena, real_lo, real_hi, k_enc, fplanes, k_dec, p_dec, k_pl, p_pl, k_gs, p_gs
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 3
    with Phase("3 tiny config: card vs CPU"):
        tcfg = get_smoke_config("qwen3-0.6b")
        tparams = lm.init_params(tcfg, seed=0, device="cpu")
        prompts = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 8)).astype(np.int32)
        for multi, cdx in ((False, None), (True, None), (False, "dected79"), (True, CODEC_MIX)):
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    rails=RailsConfig(multi_rail=multi),
                                    protection=ProtectionConfig(codecs=cdx))
            engs = {d: ServingEngine(tcfg, tparams, rel=rel, max_len=32, device=d)
                    for d in ("cpu", "cuda")}
            for v in (1.0, 0.56, 0.54):
                outs = {}
                for d, e in engs.items():
                    e.set_voltage(v)
                    outs[d] = (e.generate(prompts, 8), e._last_scrub)
                require(outs["cpu"][1] == outs["cuda"][1],
                        f"counters differ multi={multi} codecs={cdx} {v} V")
                require(np.array_equal(outs["cpu"][0], outs["cuda"][0]),
                        f"tokens differ multi={multi} codecs={cdx} {v} V")
            print(f"  multi_rail={multi} codecs={cdx}: equal tokens and counters at "
                  "1.0/0.56/0.54 V")
        # The smoke-size paper MLP with the same weights on both devices.
        scfg = paper_nn.smoke_config()
        carried = [(l_.w.numpy(), l_.b.numpy()) for l_ in EccMLP(
            scfg.layer_sizes, platform=scfg.platform, seed=1, device="cpu").layers]
        xs_s = np.random.default_rng(3).standard_normal((512, scfg.layer_sizes[0])).astype(np.float32)
        mlps = {}
        for d in ("cpu", "cuda"):
            mlps[d] = EccMLP(scfg.layer_sizes, platform=scfg.platform, seed=1, device=d)
            mlps[d].load_params(carried)
            mlps[d].store()
        unclear = 0
        for v in (0.56, 0.54):
            for ecc in (True, False):
                for batched in (True, False):
                    outs = {}
                    for d, m in mlps.items():
                        m.set_voltage(v, ecc=ecc, batched=batched)
                        planes = [t_.cpu() for l_ in m.layers
                                  for t_ in (l_.faulty.lo, l_.faulty.hi, l_.faulty.parity)]
                        outs[d] = (planes, m.stats.counters(), m.logits(xs_s).cpu())
                    tag = f"{v} V ecc={ecc} batched={batched}"
                    require(same(outs["cpu"][0], outs["cuda"][0]), f"MLP planes differ at {tag}")
                    require(np.array_equal(outs["cpu"][1], outs["cuda"][1]),
                            f"MLP counters differ at {tag}")
                    lc, lg = outs["cpu"][2], outs["cuda"][2]
                    tol = MATMUL_RTOL * float(lc.abs().max())
                    require(float((lc - lg).abs().max()) <= tol, f"MLP logits differ at {tag}")
                    top2 = torch.topk(lc, 2, dim=-1).values
                    clear = (top2[:, 0] - top2[:, 1]) > tol
                    unclear += int((~clear).sum())
                    require(torch.equal(lc.argmax(-1)[clear], lg.argmax(-1)[clear]),
                            f"MLP predictions differ at {tag}")
        print(f"  paper MLP {scfg.layer_sizes}: equal planes, counters and predictions "
              f"(logits within {MATMUL_RTOL} x max|cpu|; {unclear} rows within that of a tie) "
              f"at 0.56/0.54 V, ECC on and off, batched and per-leaf")
        del mlps

    # ---------------------------------------------------------------- 4-5
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)
    runs, traced_params, paths_extra, nominal_tokens = {}, {}, {}, {}
    for multi in (False, True):
        name = "multi-rail" if multi else "single-rail"
        with Phase(f"{4 + multi} full-width qwen3-0.6b {name} engine"), Tally() as tally:
            ops.reset_launch_count()
            run = runs[name] = {}
            fwd = {"prefill": 0, "decode": 0}  # forward passes of this path
            t = time.perf_counter()
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    rails=RailsConfig(multi_rail=multi, start_v=0.62))
            eng = ServingEngine(cfg, params, rel=rel, max_len=64)  # one voltage step
            torch.cuda.synchronize()
            run["build_s"] = time.perf_counter() - t
            mask_s = []  # one entry per later voltage step
            host_masks = eng._store.group_host_masks

            def timed_masks(v, _f=host_masks, _acc=mask_s):
                t_ = time.perf_counter()
                out = _f(v)
                _acc.append(time.perf_counter() - t_)
                return out

            eng._store.group_host_masks = timed_masks
            toks = {}
            for v in (1.0, 0.56):
                t = time.perf_counter()
                eng.set_voltage(v)
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t
                t = time.perf_counter()
                toks[v] = eng.generate(prompts, NEW_TOKENS)
                gen_s = time.perf_counter() - t
                fwd["prefill"] += 1
                fwd["decode"] += NEW_TOKENS - 1
                require(toks[v].shape == (BATCH, NEW_TOKENS), str(toks[v].shape))
                require(bool(((toks[v] >= 0) & (toks[v] < cfg.vocab)).all()), "token range")
                if v == 0.56 and not multi:  # held against the per-leaf engine (phase 8)
                    batched_056 = {
                        "planes": [(w.lo, w.hi, w.parity) for _, w in base.flatten(eng.params)
                                   if isinstance(w, ops.EccWeight)],
                        "scrub": dataclasses.asdict(eng._last_scrub), "tokens": toks[v]}
                nominal_tokens.setdefault(name, toks[1.0])
                agree = float((toks[v] == toks[1.0]).mean())
                run[f"{v}V"] = {"step_s": step_s, "host_mask_s": mask_s[-1],
                                "generate_s": gen_s,
                                "tokens_per_s": BATCH * NEW_TOKENS / gen_s,
                                "agreement_with_nominal": agree,
                                "scrub": eng._last_scrub.total().to_dict() if multi
                                else eng._last_scrub.to_dict()}
                print(f"  {v} V: step {step_s:.3f} s (host masks {mask_s[-1]:.3f} s), "
                      f"generate {gen_s:.2f} s = {BATCH * NEW_TOKENS / gen_s:.1f} tokens/s, "
                      f"agreement {agree:.3f}, scrub {run[f'{v}V']['scrub']}")
            run["steps"] = step_breakdown(eng.params, fwd)
            for k_, r_ in run["steps"].items():
                print(f"  {k_} step (batch {BATCH}): wall {r_['wall_ms']:.2f} ms")
            logits, _ = lm.prefill(eng.params, torch.as_tensor(prompts, device=dev), cfg,
                                   lm.init_cache(cfg, BATCH, 64))
            fwd["prefill"] += 1
            require(tuple(logits.shape) == (BATCH, cfg.vocab)
                    and bool(torch.isfinite(logits).all()), "prefill logits")
            # Start the canary walk from a clean interval at its start voltage.
            if not multi:
                eng.set_voltage(eng.controller.voltage)
            n_masks = len(mask_s)
            t = time.perf_counter()
            lock, hist = eng.autotune_voltage()
            torch.cuda.synchronize()
            run["autotune_s"] = time.perf_counter() - t
            run["autotune_steps"] = len(mask_s) - n_masks
            run["autotune_host_mask_s"] = sum(mask_s[n_masks:])
            run["lock"] = lock
            run["power_report"] = eng.power_report()
            if multi:
                run["history"] = {d: [(r.voltage, r.detected, r.action) for r in h]
                                  for d, h in hist.items()}
                require(eng.controller.locked, "multi-rail walk did not lock")
            else:
                run["history"] = [(r.voltage, r.detected, r.action) for r in hist]
                require(eng.controller.locked, "single-rail walk did not lock")
            print(f"  autotune: lock {lock} in {run['autotune_steps']} voltage steps, "
                  f"{run['autotune_s']:.1f} s (host masks {run['autotune_host_mask_s']:.1f} s)")
            print(f"  history {json.dumps(run['history'])}")
            print(f"  power_report {json.dumps(run['power_report'])}")

            # This path's launches: every voltage step and every matmul went
            # through the kernels, and none of the other path's ran.
            counts = ops.launch_counts()
            steps = 1 + len(mask_s)
            per_fwd = sum(w.lo.shape[0] if w.lo.ndim == 3 else 1
                          for _, w in base.flatten(eng.params) if isinstance(w, ops.EccWeight))
            require(per_fwd == 7 * cfg.n_layers, f"{per_fwd} protected matmuls per forward")
            want = {"inject_scrub": 0 if multi else steps,
                    "inject_scrub_domains": steps if multi else 0,
                    "decode": steps if multi else 0,
                    "ecc_matmul": per_fwd * (fwd["prefill"] + fwd["decode"]),
                    "encode": tally.n["packs"], "gather_scrub": 0, "inject": 0}
            require(counts == want, f"{name} launches {counts}, expected {want}")
            require(tally.n["packs"] == per_fwd + multi, f"{tally.n['packs']} weight packs")
            require(tally.n["plain_on_card"] == 0, "the plain codec ran on the card")
            run.update(launches=counts, launches_by_codec=ops.launch_counts_by_codec(),
                       voltage_steps=steps,
                       forwards=dict(fwd, decode_kernel=fwd["decode"]),
                       matmuls_per_forward=per_fwd, packs=tally.n["packs"], commits=0,
                       scrubs=0)
            print(f"  launches: {json.dumps(counts)} = {steps} voltage steps, "
                  f"{per_fwd} fused matmuls x {fwd['prefill']} prefill + "
                  f"{fwd['decode']} decode forward passes, {tally.n['packs']} weight packs")
            traced_params[name] = eng.params
            del eng, logits
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 6
    rng = np.random.default_rng(1)
    stream = [(rng.integers(0, cfg.vocab, int(rng.integers(16, 49))).astype(np.int32),
               int(rng.integers(8, 25))) for _ in range(8)]
    prefix = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    shared_reqs = [(np.concatenate([prefix, rng.integers(0, cfg.vocab, int(rng.integers(4, 17)))])
                    .astype(np.int32), int(rng.integers(8, 17))) for _ in range(8)]
    paged = {}

    def check_paged_launches(name, tally, counts, multi):
        """The paged path's launch formulas, from the path's own tally."""
        n = tally.n
        per_fwd = 7 * cfg.n_layers
        want = {"inject_scrub": 0 if multi else 1, "inject_scrub_domains": int(multi),
                "decode": int(multi), "ecc_matmul": per_fwd * (n["prefill"] + n["decode"]),
                "encode": n["packs"] + n["commits"],
                "gather_scrub": n["intervals"] + n["prefix_scrubs"], "inject": 0}
        require(counts == want, f"{name} launches {counts}, expected {want}")
        require(n["packs"] == per_fwd + multi, f"{n['packs']} weight packs")
        require(n["plain_on_card"] == 0, "the plain codec ran on the card")
        print(f"  {name} launches: {json.dumps(counts)} = 1 voltage step, {per_fwd} fused "
              f"matmuls x ({n['prefill']} prefill/chunk + {n['decode']} decode forwards), "
              f"{n['packs']} packs + {n['commits']} commits, {n['intervals']} fault intervals + "
              f"{n['prefix_scrubs']} prefix-hit admission scrubs")
        paged[name] = {"launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
                       "kv_codec": "secded72", "matmuls_per_forward": per_fwd,
                       "forwards": {"prefill": n["prefill"], "decode": n["decode"],
                                    "decode_kernel": n["decode_kernel"]},
                       "packs": n["packs"], "commits": n["commits"],
                       "scrubs": n["intervals"] + n["prefix_scrubs"], "voltage_steps": 1}

    def outputs_equal(a, b) -> bool:
        return sorted(a) == sorted(b) and all(np.array_equal(a[r], b[r]) for r in a)

    with Phase("6 paged SECDED KV serving, full width"):
        ops.reset_launch_count()
        with Tally() as tally:
            t = time.perf_counter()
            eng = ServingEngine(cfg, params, rel=ReliabilityConfig(mode="inline", voltage=1.0),
                                max_len=PAGED_MAX_LEN)
            torch.cuda.synchronize()
            print(f"  inline single-rail engine built in {time.perf_counter() - t:.2f} s")
            # a. nominal paged serve against dense generate, same batch
            dense = eng.generate(prompts, NEW_TOKENS)
            t = time.perf_counter()
            rep = eng.serve([(p, NEW_TOKENS) for p in prompts], n_lanes=BATCH)
            nominal_s = time.perf_counter() - t
            got = np.stack([rep.outputs[i] for i in range(BATCH)])
            require(np.array_equal(got, dense), "paged serve differs from dense generate")
            require(rep.kv_stats.clean == rep.kv_stats.words > 0, f"nominal scrub {rep.kv_stats}")
            print(f"  nominal: {BATCH} x {PROMPT_LEN}-token prompts, {NEW_TOKENS} new tokens: "
                  f"equal to dense generate; {rep.steps} steps, {len(rep.kv_voltages)} scrub "
                  f"intervals in {nominal_s:.2f} s")
            # b. a mixed stream at a 0.56 V kv rail, arena small enough to preempt
            t = time.perf_counter()
            srep = eng.serve(stream, n_lanes=4, kv_voltage=0.56, n_pages=STREAM_PAGES)
            torch.cuda.synchronize()
            stream_s = time.perf_counter() - t
            n_tok = sum(len(v) for v in srep.outputs.values())
            require(len(srep.outputs) == len(stream), "stream did not finish")
            require(srep.preemptions >= 1, f"no preemption with {STREAM_PAGES} pages")
            require(srep.kv_stats.corrected > 0, f"no corrected word at 0.56 V: {srep.kv_stats}")
            require(all(bool(((v >= 0) & (v < cfg.vocab)).all()) for v in srep.outputs.values()),
                    "token range")
            paged["stream"] = {
                "requests": len(stream), "prompt_lens": [len(p) for p, _ in stream],
                "new_tokens": [n for _, n in stream], "n_pages": STREAM_PAGES,
                "wall_s": stream_s, "tokens": n_tok, "tokens_per_s": n_tok / stream_s,
                "steps": srep.steps, "preemptions": srep.preemptions,
                "scrub_intervals": len(srep.kv_voltages), "kv_stats": srep.kv_stats.to_dict(),
            }
            print(f"  stream of {len(stream)} requests at 0.56 V kv rail, {STREAM_PAGES} pages: "
                  f"{n_tok} tokens in {stream_s:.2f} s = {n_tok / stream_s:.1f} tokens/s, "
                  f"{srep.steps} steps, {srep.preemptions} preemptions, "
                  f"{len(srep.kv_voltages)} scrub intervals, kv {srep.kv_stats.to_dict()}")
            # c. shared prefixes against private pages
            priv = eng.serve(shared_reqs, n_lanes=4)
            shr = eng.serve(shared_reqs, n_lanes=4, share_prefix=True)
            require(outputs_equal(priv.outputs, shr.outputs), "shared differs from private")
            require(shr.prefix_hit_tokens > 0, "no prefix hit")
            require(shr.pages_free_at_end == shr.arena.n_pages, "pages leaked")
            print(f"  share_prefix: equal to private, {shr.prefix_hit_tokens} prefix-hit tokens, "
                  f"scrubbed words {shr.kv_stats.words} vs {priv.kv_stats.words} private")
            # d. speculative decoding with a 2-layer qwen3-width draft
            dcfg = dataclasses.replace(cfg, n_layers=2)
            dparams = lm.init_params(dcfg, seed=1, device=dev)
            reqs = [(p, NEW_TOKENS) for p in prompts]
            greedy = eng.serve(reqs, n_lanes=BATCH, scrub_interval=4)
            spec = eng.serve(reqs, n_lanes=BATCH, scrub_interval=4, speculative=4,
                             draft_params=dparams, draft_cfg=dcfg)
            require(outputs_equal(greedy.outputs, spec.outputs), "speculative differs from greedy")
            require(spec.spec_dispatches > 0, "no speculative block ran")
            print(f"  speculative=4: equal to greedy; {spec.spec_dispatches} verify blocks emitted "
                  f"{spec.spec_emitted} tokens ({greedy.steps} greedy steps)")
        check_paged_launches("paged", tally, ops.launch_counts(), multi=False)

        # Where a stream's time goes: one decode step, commit, fault
        # interval and interval scrub at the stream's shapes.
        arena = srep.arena
        geom = arena.geom
        live = np.arange(min(STREAM_PAGES, 4 * 4), dtype=np.int32)
        table = np.full((4, 4), arena.scratch_page, np.int32)
        table.reshape(-1)[: len(live)] = live
        table_d = torch.as_tensor(table.reshape(-1), device=dev)
        cache = lm.init_cache(cfg, 4, PAGED_MAX_LEN)
        tok4 = torch.zeros(4, 1, dtype=torch.int64, device=dev)
        pos4 = torch.tensor([40, 33, 20, 57], device=dev)
        kv4 = 57 + 1  # the scheduler's host bound on the keys a step reads
        payload4 = torch.randn(4, geom.token_f32, device=dev)
        pages4, slots4 = np.array([0, 3, 6, 9]), np.array([1, 2, 3, 4])
        arena.set_voltage(0.56)
        tick_s = []

        def timed_tick():
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            arena.tick()
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t_)

        parts = {
            "decode_step_ms": min(wall_ms(lambda: lm.decode_step(eng.params, tok4, cfg, cache,
                                                                 pos4, kv4)) for _ in range(3)),
            "commit_ms": min(wall_ms(lambda: arena.commit_tokens(payload4, pages4, slots4))
                             for _ in range(3)),
            "tick_ms": min(wall_ms(timed_tick) for _ in range(3)),
            "interval_scrub_ms": min(wall_ms(lambda: arena.scrub_pages(table)) for _ in range(3)),
            "interval_scrub_kernel_ms": sync_ms(
                lambda: ops.gather_scrub_pages(arena.lo, arena.hi, arena.parity, table_d,
                                               geom.words_per_page), 20),
            "interval_pages": int(table.size), "arena_words": arena.n_words,
        }
        # Traced after every timed part of this engine's path: device time
        # inside one decode step and one fault interval + scrub.
        for key, fn in (("decode_step", lambda: lm.decode_step(eng.params, tok4, cfg, cache, pos4, kv4)),
                        ("interval", lambda: (arena.tick(), arena.scrub_pages(table)))):
            evs = device_events(fn)
            if evs:
                busy_ms_ = busy_us(evs) / 1e3
                parts[f"{key}_device_busy_ms"] = busy_ms_
                parts[f"{key}_device_events"] = len(evs)
                wall = parts["decode_step_ms" if key == "decode_step" else "tick_ms"]
                if key == "interval":
                    wall += parts["interval_scrub_ms"]
                parts[f"{key}_device_idle_share"] = 1.0 - busy_ms_ / wall
        paged["breakdown"] = parts
        print(f"  stream breakdown (4 lanes): decode step {parts['decode_step_ms']:.2f} ms, "
              f"commit {parts['commit_ms']:.3f} ms, fault interval (device masks) "
              f"{parts['tick_ms']:.2f} ms, interval scrub of {table.size} pages "
              f"{parts['interval_scrub_ms']:.2f} ms wall (kernel "
              f"{parts['interval_scrub_kernel_ms']:.3f} ms)")
        if "decode_step_device_busy_ms" in parts:
            print(f"  traced: decode step device busy {parts['decode_step_device_busy_ms']:.2f} ms "
                  f"(idle share {parts['decode_step_device_idle_share']:.3f}); interval device "
                  f"busy {parts.get('interval_device_busy_ms', 0.0):.2f} ms")
        else:
            print("  traced: device time not measured (the profiler traced no device event)")
        del eng, srep, priv, shr, greedy, spec, dparams, arena, cache
        torch.cuda.empty_cache()

        # e. the multi-rail engine walks its kv rail on the scrubs' DED counters
        ops.reset_launch_count()
        with Tally() as tally:
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    rails=RailsConfig(multi_rail=True, start_v=0.62))
            meng = ServingEngine(cfg, params, rel=rel, max_len=PAGED_MAX_LEN)
            wrep = meng.serve(stream, n_lanes=4, walk_kv=True)
        check_paged_launches("paged-multi-rail", tally, ops.launch_counts(), multi=True)
        kv = meng.controller.rails["kv"]
        walk = [(r.voltage, r.corrected, r.detected, r.action) for r in kv.history]
        # the rail's record ends at its lock; the stream's intervals go on
        require(0 < len(walk) <= len(wrep.kv_voltages), "the kv rail did not walk")
        paged["walk_kv"] = {"locked": kv.locked, "voltage": kv.voltage, "history": walk,
                            "power_report": meng.power_report(),
                            "kv_stats": wrep.kv_stats.to_dict()}
        print(f"  walk_kv: kv rail {'locked' if kv.locked else 'not locked'} at {kv.voltage:.2f} V "
              f"after {len(walk)} intervals; walk (V, corrected, detected, action) "
              f"{json.dumps(walk)}")
        print(f"  power_report {json.dumps(paged['walk_kv']['power_report'])}")
        del meng, wrep
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 7
    fig3 = {}
    with Phase("7 paper Fig. 3 NN accelerator, full width"):
        ops.reset_launch_count()
        with Tally() as tally:
            tally._wrap(EccMLP, "set_voltage", lambda self_, v, ecc=True, batched=True: (
                "mlp_batched" if batched else "mlp_per_leaf" if ecc else "mlp_per_leaf_no_ecc"))
            tally._wrap(EccMLP, "logits",
                        lambda self_, xs, fuse=True: "mlp_fused" if fuse else "mlp_naive")
            xtr, ytr = mnist.make_dataset(MLP_TRAIN, split="train")
            xte, yte = mnist.make_dataset(MLP_TEST, split="test")
            mlp = EccMLP(pcfg.layer_sizes, platform=pcfg.platform, seed=0, device=dev)
            t = time.perf_counter()
            loss = mlp.train(xtr, ytr, steps=pcfg.train_steps, batch=pcfg.batch_size, lr=pcfg.lr)
            torch.cuda.synchronize()
            fig3.update(layer_sizes=list(pcfg.layer_sizes), train=MLP_TRAIN, test=MLP_TEST,
                        steps=pcfg.train_steps, train_s=time.perf_counter() - t, final_loss=loss,
                        words=mlp._store.n_words)
            prof = PLATFORMS[pcfg.platform]
            mlp.set_voltage(prof.v_nom, ecc=True)
            pred0 = mlp.predict(xte)
            err_free = float((pred0 != yte).mean())
            print(f"  trained {pcfg.layer_sizes} for {pcfg.train_steps} steps in "
                  f"{fig3['train_s']:.2f} s (loss {loss:.4f}); {fig3['words']} protected words; "
                  f"fault-free test error {err_free:.4f}")
            require(err_free < 0.10, f"fault-free error {err_free} >= 0.10")
            volts = [prof.v_nom] + [round(prof.v_min - 0.01 * i, 2) for i in
                                    range(int(round((prof.v_min - prof.v_crash) / 0.01)) + 1)]
            rows = []
            for v in volts:
                for ecc in (True, False):
                    t = time.perf_counter()
                    mlp.set_voltage(v, ecc=ecc)
                    pred = mlp.predict(xte)
                    row = {"voltage": v, "ecc": ecc, "err": float((pred != yte).mean()),
                           "divergence_vs_clean": float((pred != pred0).mean()),
                           **mlp.stats.coverage_row(), "power_w": mlp.power_w(),
                           "bram_power_w": mlp.bram_power_w(),
                           "bram_saving_vs_vmin": power_saving(prof.v_min, v, ecc=ecc),
                           "step_and_predict_ms": 1e3 * (time.perf_counter() - t)}
                    rows.append(row)
                    print(f"  fig3 {v:.2f} V ecc={int(ecc)}: err {row['err']:.4f}, divergence "
                          f"{row['divergence_vs_clean']:.4f}, faulty words {row['faulty_words']}, "
                          f"corrected {row['corrected']}, detected {row['detected']}, silent "
                          f"{row['silent']}, coverage correctable "
                          f"{row['coverage_correctable']:.4f} detectable "
                          f"{row['coverage_detectable']:.4f} silent {row['coverage_silent']:.4f}, "
                          f"power {row['power_w']:.4f} W, BRAM saving vs V_min "
                          f"{row['bram_saving_vs_vmin']:.4f}, step+predict "
                          f"{row['step_and_predict_ms']:.1f} ms")
            fig3["rows"] = rows
            at_crash = {r["ecc"]: r["err"] for r in rows if r["voltage"] == prof.v_crash}
            require(at_crash[True] <= at_crash[False],
                    f"err with ECC {at_crash[True]} > without {at_crash[False]} at V_crash")
            # Fused and naive reads at V_crash, with ECC on and off.
            for ecc in (True, False):
                mlp.set_voltage(prof.v_crash, ecc=ecc)
                require(np.array_equal(mlp.predict(xte, fuse=True), mlp.predict(xte, fuse=False)),
                        f"fused and naive predictions differ at V_crash ecc={ecc}")
            # Per-leaf steps against batched ones, bit for bit.
            for v, ecc in ((0.56, True), (0.55, False), (0.54, True)):
                mlp.set_voltage(v, ecc=ecc, batched=False)
                per = [t_ for l_ in mlp.layers for t_ in (l_.faulty.lo, l_.faulty.hi, l_.faulty.parity)]
                per_cnt = mlp.stats.counters()
                mlp.set_voltage(v, ecc=ecc, batched=True)
                bat = [t_ for l_ in mlp.layers for t_ in (l_.faulty.lo, l_.faulty.hi, l_.faulty.parity)]
                require(same(per, bat) and np.array_equal(per_cnt, mlp.stats.counters()),
                        f"per-leaf differs from batched at {v} V ecc={ecc}")
            print(f"  V_crash: error {at_crash[True]:.4f} with ECC <= {at_crash[False]:.4f} without; "
                  "fused = naive predictions; per-leaf = batched planes and counters at "
                  "(0.56 V, ECC), (0.55 V, no ECC), (0.54 V, ECC)")
        n_ = tally.n
        n_layers = len(mlp.layers)
        per_leaf = n_.get("mlp_per_leaf", 0) + n_.get("mlp_per_leaf_no_ecc", 0)
        counts = ops.launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update(inject_scrub=n_.get("mlp_batched", 0), inject=n_layers * per_leaf,
                    decode=n_layers * (per_leaf + n_.get("mlp_naive", 0)),
                    encode=n_["packs"] + n_layers * n_.get("mlp_per_leaf_no_ecc", 0),
                    ecc_matmul=n_layers * n_.get("mlp_fused", 0))
        require(counts == want, f"fig3 launches {counts}, expected {want}")
        require(n_["packs"] == n_layers, f"{n_['packs']} weight packs")
        require(n_["plain_on_card"] == 0, "the plain codec ran on the card")
        print(f"  fig3 launches: {json.dumps(counts)} = {n_.get('mlp_batched', 0)} batched steps, "
              f"{per_leaf} per-leaf steps ({n_.get('mlp_per_leaf_no_ecc', 0)} without ECC), "
              f"{n_.get('mlp_fused', 0)} fused + {n_.get('mlp_naive', 0)} naive predicts, "
              f"{n_['packs']} packs, x {n_layers} layers")
        paths_extra["fig3"] = {"launches": counts, "launches_by_codec": ops.launch_counts_by_codec(),
                               "matmuls_per_forward": n_layers,
                               "forwards": {"prefill": n_.get("mlp_fused", 0), "decode": 0,
                                            "decode_kernel": 0},
                               "packs": want["encode"], "commits": 0}
        # The fused matmul at the MLP's shapes (M = test images), held
        # against its plain version and timed after the path's count.
        mlp.set_voltage(prof.v_crash, ecc=True)
        h, acts = torch.as_tensor(xte, device=dev), []
        for i, l_ in enumerate(mlp.layers):
            acts.append(h)
            h = ops.ecc_matmul(h, l_.faulty) + l_.b
            h = torch.relu(h) if i < len(mlp.layers) - 1 else h
        deq = [ref.ecc_matmul_ref(torch.eye(l_.faulty.k, device=dev), l_.faulty.lo,
                                  l_.faulty.hi, l_.faulty.parity, l_.faulty.scale)
               for l_ in mlp.layers]
        worst = 0.0
        for x_, l_ in zip(acts, mlp.layers):
            k_o, p_o = ops.ecc_matmul(x_, l_.faulty), ref.ecc_matmul_ref(
                x_, l_.faulty.lo, l_.faulty.hi, l_.faulty.parity, l_.faulty.scale)
            err = float((k_o - p_o).abs().max())
            require(err <= MATMUL_RTOL * float(p_o.abs().max()), f"MLP ecc_matmul err {err}")
            require(torch.equal(ops.ecc_matmul(x_[:BATCH], l_.faulty), k_o[:BATCH]),
                    f"MLP ecc_matmul K={l_.faulty.k}: the M={BATCH} rows differ from the "
                    f"same rows at M={MLP_TEST}")
            worst = max(worst, err)
        ffma = sum(2 * MLP_TEST * l_.faulty.k * l_.faulty.n for l_ in mlp.layers)
        nbytes = sum(4 * MLP_TEST * (l_.faulty.k + l_.faulty.n)
                     + 9 * l_.faulty.k * l_.faulty.n // 8 + 4 * l_.faulty.n for l_ in mlp.layers)
        bt, ot = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ffma / FP32_FLOPS
        report["ecc_matmul_prefill"]["mlp"] = {
            "M": MLP_TEST, "shapes": [[l_.faulty.k, l_.faulty.n] for l_ in mlp.layers],
            "per": "the 3 layers of one predict", "max_abs_err": worst,
            "ms": sync_ms(lambda: [ops.ecc_matmul(x_, l_.faulty)
                                   for x_, l_ in zip(acts, mlp.layers)], 20),
            "plain_ms": sync_ms(lambda: [ref.ecc_matmul_ref(
                x_, l_.faulty.lo, l_.faulty.hi, l_.faulty.parity, l_.faulty.scale)
                for x_, l_ in zip(acts, mlp.layers)], 5),
            "library_ms": sync_ms(lambda: [torch.matmul(x_, w_) for x_, w_ in zip(acts, deq)], 20),
            "bound_ms": max(bt, ot), "bound_by": "bytes" if bt >= ot else "operations",
        }
        r_ = report["ecc_matmul_prefill"]["mlp"]
        print(f"  ecc_matmul at M={MLP_TEST} over the MLP's 3 layers: max err {worst:.3e}, "
              f"the M={BATCH} rows equal ({b3_names['decode']} vs {b3_names['tiled']}), "
              f"{r_['ms']:.4f} ms, bound {r_['bound_ms']:.4f} ms ({r_['bound_by']}), plain "
              f"{r_['plain_ms']:.3f} ms, torch.matmul {r_['library_ms']:.4f} ms")
        del mlp, acts, deq, h, xtr, xte

    # ---------------------------------------------------------------- 8
    with Phase("8 per-leaf and domain-mode engines, full width"):
        ops.reset_launch_count()
        with Tally() as tally:
            t = time.perf_counter()
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    fault_model=FaultModelConfig(batched=False))
            leng = ServingEngine(cfg, params, rel=rel, max_len=64)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t
            t = time.perf_counter()
            leng.set_voltage(0.56)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t
            ltoks = leng.generate(prompts, NEW_TOKENS)
        leaves = [w for _, w in base.flatten(leng.params) if isinstance(w, ops.EccWeight)]
        require(len(leaves) == len(batched_056["planes"]) and all(
            same((w.lo, w.hi, w.parity), p_) for w, p_ in zip(leaves, batched_056["planes"])),
            "per-leaf planes differ from the batched engine's at 0.56 V")
        require(dataclasses.asdict(leng._last_scrub) == batched_056["scrub"],
                f"per-leaf counters {leng._last_scrub} differ from the batched engine's")
        require(np.array_equal(ltoks, batched_056["tokens"]),
                "per-leaf tokens differ from the batched engine's at 0.56 V")
        n_ = tally.n
        per_fwd = 7 * cfg.n_layers
        counts = ops.launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update(inject=2 * len(leaves), decode=2 * len(leaves), encode=n_["packs"],
                    ecc_matmul=per_fwd * (n_["prefill"] + n_["decode"]))
        require(counts == want, f"per-leaf launches {counts}, expected {want}")
        require(n_["packs"] == per_fwd and n_["plain_on_card"] == 0, f"per-leaf tally {n_}")
        per_leaf_run = {"build_s": build_s, "step_056_s": step_s,
                        "scrub_056": leng._last_scrub.to_dict(), "leaves": len(leaves)}
        print(f"  per-leaf engine: built in {build_s:.2f} s; 0.56 V step {step_s:.2f} s "
              f"({len(leaves)} inject + {len(leaves)} scrub launches); planes, counters and "
              f"tokens equal to phase 4's batched engine; scrub {per_leaf_run['scrub_056']}")
        print(f"  per-leaf launches: {json.dumps(counts)} = 2 voltage steps x {len(leaves)} leaves, "
              f"{n_['packs']} packs, {per_fwd} fused matmuls x ({n_['prefill']} prefill + "
              f"{n_['decode']} decode forwards)")
        paths_extra["per-leaf"] = {"launches": counts,
                                   "launches_by_codec": ops.launch_counts_by_codec(),
                                   "matmuls_per_forward": per_fwd,
                                   "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                                                "decode_kernel": n_["decode_kernel"]},
                                   "packs": n_["packs"], "commits": 0}
        del leng, leaves, batched_056
        torch.cuda.empty_cache()

        ops.reset_launch_count()
        mask_s = []
        real_gather = memory.gather_masks

        def timed_gather(*a, **kw):
            t_ = time.perf_counter()
            out = real_gather(*a, **kw)
            mask_s.append(time.perf_counter() - t_)
            return out

        memory.gather_masks = timed_gather
        try:
            with Tally() as tally:
                t = time.perf_counter()
                deng = ServingEngine(cfg, params, rel=ReliabilityConfig(voltage=1.0), max_len=64)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t
                n_arrays, n_words = len(deng.domain.names()), sum(
                    deng.domain.entry(k).n_words for k in deng.domain.names())
                require(all(same_bits(a_, b_) for (_, a_), (_, b_) in
                            zip(base.flatten(deng.params), base.flatten(params))),
                        "domain mode's nominal read-back differs from the params it wrote")
                dtoks = deng.generate(prompts, NEW_TOKENS)
                plain_toks = ServingEngine(cfg, params, rel=None, max_len=64).generate(
                    prompts, NEW_TOKENS)
                require(np.array_equal(dtoks, plain_toks),
                        "domain mode at nominal differs from the unprotected model")
                before = deng.stats.counters()
                t = time.perf_counter()
                deng.set_voltage(0.56)
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t
                step_cnt = deng.stats.counters() - before
                t = time.perf_counter()
                d56 = deng.generate(prompts, NEW_TOKENS)
                gen_s = time.perf_counter() - t
        finally:
            memory.gather_masks = real_gather
        require(d56.shape == (BATCH, NEW_TOKENS) and bool(((d56 >= 0) & (d56 < cfg.vocab)).all()),
                "domain-mode tokens at 0.56 V")
        step_stats = dict(zip(("clean", "corrected", "detected", "silent", "words_1bit",
                               "words_2bit", "words_multi", "faulty_bits"), step_cnt.tolist()))
        require(step_stats["corrected"] > 0, f"no corrected word at 0.56 V: {step_stats}")
        # The 0.56 V read-back against the plain read on the same masks (the
        # fields keep their draw): every array bit for bit, and the counters.
        require(deng.rel.ecc, "the domain engine reads with ECC")
        plain_cnt = np.zeros_like(step_cnt)
        for key, arr in base.flatten(deng.params):
            e_ = deng.domain.entry("w" + key)
            m_ = faultsim.device_masks(e_.field, 0.56, dev)
            plo, phi, pst = ref.decode_ref(*ref.inject_ref(e_.lo, e_.hi, e_.parity, *m_))
            require(same_bits(arr, quantize.words_to_array(plo, phi, e_.nbytes, e_.shape,
                                                           e_.dtype)),
                    f"domain read-back of {key} at 0.56 V differs from the plain read")
            plain_cnt += FaultStats.from_decode(pst, faultsim.flip_counts(*m_)).counters()
            del m_, plo, phi, pst
        require(np.array_equal(plain_cnt, step_cnt),
                f"domain counters {step_cnt.tolist()} differ from the plain read's "
                f"{plain_cnt.tolist()}")
        print(f"  domain 0.56 V read-back: {n_arrays} arrays bit-identical to B7 + B5's plain "
              "versions on the same masks, counters equal")
        n_ = tally.n
        counts = ops.launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update(inject=2 * n_arrays, decode=2 * n_arrays, encode=n_arrays)
        require(counts == want, f"domain launches {counts}, expected {want}")
        require(n_["prefill"] == n_["decode"] == 0 and n_["plain_on_card"] == 0,
                f"domain tally {n_}")
        domain_run = {"build_s": build_s, "arrays": n_arrays, "words": n_words,
                      "step_056_s": step_s, "host_mask_s": sum(mask_s),
                      "generate_056_s": gen_s, "agreement_056_with_nominal":
                      float((d56 == dtoks).mean()), "stats_056": step_stats}
        print(f"  domain engine: {n_arrays} arrays, {n_words} words, built (write + nominal "
              f"read) in {build_s:.2f} s; nominal tokens equal the unprotected model's")
        print(f"  domain 0.56 V step {step_s:.2f} s (host masks {sum(mask_s):.2f} s), "
              f"generate {gen_s:.2f} s, agreement with nominal "
              f"{domain_run['agreement_056_with_nominal']:.3f}, stats {json.dumps(step_stats)}")
        print(f"  domain launches: {json.dumps(counts)} = 2 reads x {n_arrays} arrays, "
              f"{n_arrays} writes")
        paths_extra["domain"] = {"launches": counts,
                                 "launches_by_codec": ops.launch_counts_by_codec(),
                                 "matmuls_per_forward": per_fwd,
                                 "forwards": {"prefill": 0, "decode": 0, "decode_kernel": 0},
                                 "packs": n_arrays,
                                 "commits": 0}
        del deng
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 9
    codec_run = {}

    def codec_launch_check(name, counts, by_codec, want_codec, want_total):
        """Per-codec launch formulas of a codec path, and its totals."""
        got = {k: v for k, v in by_codec.items() if v}
        want = {k: {c: n for c, n in v.items() if n} for k, v in want_codec.items()}
        require(got == {k: v for k, v in want.items() if v},
                f"{name} launches by codec {by_codec}, expected {want}")
        require(counts == want_total, f"{name} launches {counts}, expected {want_total}")
        print(f"  {name} launches: {json.dumps(counts)}; by codec {json.dumps(by_codec)}")

    with Phase("9 per-domain-codec engine, full width"):
        per_fwd = 7 * cfg.n_layers
        ops.reset_launch_count()
        with Tally() as tally:
            tally._wrap(ServingEngine, "set_rails", "rail_steps")
            t = time.perf_counter()
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    rails=RailsConfig(multi_rail=True, start_v=0.62),
                                    protection=ProtectionConfig(codecs=CODEC_MIX))
            ceng = ServingEngine(cfg, params, rel=rel, max_len=PAGED_MAX_LEN)
            torch.cuda.synchronize()
            codec_run["build_s"] = time.perf_counter() - t
            store = ceng._store
            codec_run["groups"] = {g.name: {"words": g.n_words, "leaves": len(g.slot_ids),
                                            "check_bits": g.codec.n_check} for g in store.groups}
            print(f"  engine built in {codec_run['build_s']:.2f} s; domains {store.domains}, "
                  f"codec groups {json.dumps(codec_run['groups'])}")
            mask_s, refresh_ms = [], []
            real_gm, real_re = store.group_host_masks, ceng._reassemble_params

            def timed_gm(v, _f=real_gm, _acc=mask_s):
                t_ = time.perf_counter()
                out = _f(v)
                _acc.append(time.perf_counter() - t_)
                return out

            def timed_re(leaves, _f=real_re, _acc=refresh_ms):
                out = []
                _acc.append(wall_ms(lambda: out.append(_f(leaves))))
                return out[0]

            store.group_host_masks, ceng._reassemble_params = timed_gm, timed_re
            ctoks = {1.0: ceng.generate(prompts, NEW_TOKENS)}
            require(np.array_equal(ctoks[1.0], nominal_tokens["multi-rail"]),
                    "the codec engine's nominal tokens differ from phase 5's SECDED engine")
            print("  nominal generate: tokens equal to phase 5's multi-rail SECDED engine")
            # a 0.56 V step on every rail, held against the plain versions
            t = time.perf_counter()
            ceng.set_rails(dict.fromkeys(store.domains, 0.56))
            torch.cuda.synchronize()
            codec_run["step_056_s"] = time.perf_counter() - t
            codec_run["step_056_host_mask_s"] = mask_s[-1]
            codec_run["refresh_056_ms"] = refresh_ms[-1]
            with tally.outside():
                gm = real_gm(dict.fromkeys(store.domains, 0.56))  # the fields' kept masks
                plain = sum(ref.inject_scrub_domains_ref(g.lo, g.hi, g.check, *m, g.dom_ids,
                                                         len(store.domains), codec=g.name)[3]
                            for g, m in zip(store.groups, gm))
                got = np.stack([ceng._last_scrub[d].counters() for d in store.domains])
                require(np.array_equal(plain.cpu().numpy(), got),
                        f"codec engine 0.56 V counters {got.tolist()} differ from the plain "
                        f"versions' {plain.tolist()}")
                del gm, plain
            codec_run["scrub_056"] = {d: ceng._last_scrub[d].to_dict() for d in store.domains}
            ctoks[0.56] = ceng.generate(prompts, NEW_TOKENS)
            print(f"  0.56 V step {codec_run['step_056_s']:.2f} s (host masks "
                  f"{codec_run['step_056_host_mask_s']:.2f} s, refresh "
                  f"{codec_run['refresh_056_ms']:.1f} ms); counters equal to the plain versions' "
                  f"on the same masks: {json.dumps(codec_run['scrub_056'])}; tokens agree with "
                  f"nominal {float((ctoks[0.56] == ctoks[1.0]).mean()):.3f}")
            # the DED-canary walk from its warm start
            n_masks = len(mask_s)
            t = time.perf_counter()
            lock, hist = ceng.autotune_voltage()
            torch.cuda.synchronize()
            codec_run.update(autotune_s=time.perf_counter() - t,
                             autotune_steps=len(mask_s) - n_masks,
                             autotune_host_mask_s=sum(mask_s[n_masks:]), lock=lock,
                             history={d: [(r.voltage, r.corrected, r.detected, r.action,
                                           r.codec) for r in h] for d, h in hist.items()})
            require(ceng.controller.locked, "the codec engine's walk did not lock")
            pr = codec_run["power_report"] = ceng.power_report()
            want_codecs = {"attention": "parity65", "mlp": "dected79", "embedding": "secded72"}
            require({d: pr["codecs"][d] for d in want_codecs} == want_codecs,
                    f"power_report codecs {pr['codecs']}")
            require({d: pr["check_bits"][d] for d in want_codecs}
                    == {"attention": 1, "mlp": 15, "embedding": 8},
                    f"power_report check bits {pr['check_bits']}")
            print(f"  autotune: lock {lock} in {codec_run['autotune_steps']} voltage steps, "
                  f"{codec_run['autotune_s']:.1f} s (host masks "
                  f"{codec_run['autotune_host_mask_s']:.1f} s)")
            print(f"  history (V, corrected, detected, action, codec) "
                  f"{json.dumps(codec_run['history'])}")
            print(f"  power_report {json.dumps(pr)}")
            ctoks["lock"] = ceng.generate(prompts, NEW_TOKENS)
            codec_run["agreement_at_lock"] = float((ctoks["lock"] == ctoks[1.0]).mean())
            print(f"  generate at the locks: agreement with nominal "
                  f"{codec_run['agreement_at_lock']:.3f}")
            # paged serve with ileave88 kv pages
            rep = ceng.serve([(p_, NEW_TOKENS) for p_ in prompts], n_lanes=BATCH, kv_voltage=1.0)
            got = np.stack([rep.outputs[i] for i in range(BATCH)])
            require(np.array_equal(got, ceng.generate(prompts, NEW_TOKENS)),
                    "paged serve with ileave88 pages differs from dense generate")
            require(rep.arena.codec_name == "ileave88" and rep.arena.parity.dtype == torch.int32
                    and rep.kv_stats.clean == rep.kv_stats.words > 0,
                    f"nominal ileave88 serve: {rep.arena.codec_name} {rep.kv_stats}")
            print(f"  serve at a nominal kv rail (ileave88 pages, weights at the locks): equal to "
                  f"dense generate; {rep.steps} steps")
            t = time.perf_counter()
            srep = ceng.serve(stream, n_lanes=4, kv_voltage=0.56, n_pages=STREAM_PAGES)
            torch.cuda.synchronize()
            stream_s = time.perf_counter() - t
            n_tok = sum(len(v) for v in srep.outputs.values())
            require(len(srep.outputs) == len(stream) and srep.preemptions >= 1,
                    f"ileave88 stream: {len(srep.outputs)} finished, {srep.preemptions} preempted")
            require(srep.kv_stats.corrected > 0, f"no corrected kv word: {srep.kv_stats}")
            codec_run["stream"] = {"wall_s": stream_s, "tokens": n_tok,
                                   "tokens_per_s": n_tok / stream_s, "steps": srep.steps,
                                   "preemptions": srep.preemptions,
                                   "kv_stats": srep.kv_stats.to_dict()}
            print(f"  stream of {len(stream)} requests at a 0.56 V kv rail (ileave88, "
                  f"{STREAM_PAGES} pages): {n_tok} tokens in {stream_s:.2f} s = "
                  f"{n_tok / stream_s:.1f} tokens/s, {srep.steps} steps, {srep.preemptions} "
                  f"preemptions, kv {srep.kv_stats.to_dict()}")
            power_after = ceng.power_report()
        n_ = tally.n
        steps = n_["rail_steps"]
        leaves = {g.name: len(g.slot_ids) for g in store.groups}
        refreshed = sum(n for c, n in leaves.items() if c != "secded72")
        counts, by_codec = ops.launch_counts(), ops.launch_counts_by_codec()
        intervals = n_["intervals"] + n_["prefix_scrubs"]
        want_codec = {
            "inject_scrub": {},
            "inject_scrub_domains": {c: steps for c in leaves},
            "decode": {c: steps * n for c, n in leaves.items()},  # the embedding is secded72
            "encode": {"secded72": n_["packs"] + 1 + steps * refreshed, "parity65": 1,
                       "dected79": 1, "ileave88": n_["commits"]},
            "gather_scrub": {"ileave88": intervals},
        }
        want_total = {k: sum(v.values()) for k, v in want_codec.items()}
        want_total.update(ecc_matmul=per_fwd * (n_["prefill"] + n_["decode"]), inject=0)
        require(leaves == {"parity65": 4, "dected79": 3, "secded72": 1}, f"groups {leaves}")
        require(n_["packs"] == per_fwd + 1 and n_["plain_on_card"] == 0, f"codec tally {n_}")
        codec_launch_check("codec-multi-rail", counts, by_codec, want_codec,
                           {k: want_total[k] for k in counts})
        print(f"  = {steps} rail steps x {len(leaves)} codec groups, {refreshed} refreshed + 1 "
              f"embedding decodes and {refreshed} re-encodes per step, {n_['packs']} packs + "
              f"{n_['commits']} ileave88 commits, {intervals} ileave88 scrubs, {per_fwd} fused "
              f"matmuls x ({n_['prefill']} prefill + {n_['decode']} decode forwards)")
        paths_extra["codec-multi-rail"] = {
            "launches": counts, "launches_by_codec": by_codec, "kv_codec": "ileave88",
            "matmuls_per_forward": per_fwd,
            "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                         "decode_kernel": n_["decode_kernel"]},
            "packs": n_["packs"], "commits": n_["commits"], "voltage_steps": steps}
        codec_run.update(launches=counts, launches_by_codec=by_codec, rail_steps=steps,
                         refresh_ms=refresh_ms, power_report_after_serve=power_after)
        # a fault interval (88 bitplanes drawn on the card) and an interval
        # scrub of the stream's ileave88 arena, as phase 6 times SECDED's
        arena = srep.arena
        table = np.full((4, 4), arena.scratch_page, np.int32)
        table.reshape(-1)[: min(STREAM_PAGES, 16)] = np.arange(min(STREAM_PAGES, 16))
        table_d = torch.as_tensor(table.reshape(-1), device=dev)
        arena.set_voltage(0.56)
        codec_run["stream_breakdown"] = {
            "tick_ms": min(wall_ms(arena.tick) for _ in range(3)),
            "interval_scrub_ms": min(wall_ms(lambda: arena.scrub_pages(table)) for _ in range(3)),
            "interval_scrub_kernel_ms": sync_ms(
                lambda: ops.gather_scrub_pages(arena.lo, arena.hi, arena.parity, table_d,
                                               arena.geom.words_per_page, codec="ileave88"), 20),
            "interval_pages": int(table.size), "arena_words": arena.n_words}
        print(f"  ileave88 stream breakdown: fault interval (device masks, 88 bitplanes) "
              f"{codec_run['stream_breakdown']['tick_ms']:.2f} ms, interval scrub of "
              f"{table.size} pages {codec_run['stream_breakdown']['interval_scrub_ms']:.2f} ms "
              f"wall (kernel {codec_run['stream_breakdown']['interval_scrub_kernel_ms']:.3f} ms)")
        del ceng, store, rep, srep, real_gm, real_re, arena
        torch.cuda.empty_cache()

        # the single-rail dected79 engine: one 0.56 V step and generate
        ops.reset_launch_count()
        with Tally() as tally:
            tally._wrap(ServingEngine, "set_voltage", "voltage_steps")
            rel = ReliabilityConfig(mode="inline", voltage=1.0,
                                    protection=ProtectionConfig(codecs="dected79"))
            deng = ServingEngine(cfg, params, rel=rel, max_len=64)
            dtoks = {1.0: deng.generate(prompts, NEW_TOKENS)}
            require(np.array_equal(dtoks[1.0], nominal_tokens["single-rail"]),
                    "the dected79 engine's nominal tokens differ from phase 4's SECDED engine")
            t = time.perf_counter()
            deng.set_voltage(0.56)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t
            dtoks[0.56] = deng.generate(prompts, NEW_TOKENS)
            scrub = deng._last_scrub.to_dict()
        n_ = tally.n
        steps = n_["voltage_steps"]
        counts, by_codec = ops.launch_counts(), ops.launch_counts_by_codec()
        want_codec = {
            "inject_scrub": {"dected79": steps}, "inject_scrub_domains": {},
            "decode": {"dected79": 7 * steps},
            "encode": {"secded72": n_["packs"] + 7 * steps, "dected79": 1}, "gather_scrub": {},
        }
        want_total = {k: sum(v.values()) for k, v in want_codec.items()}
        want_total.update(ecc_matmul=per_fwd * (n_["prefill"] + n_["decode"]), inject=0)
        require(n_["packs"] == per_fwd and n_["plain_on_card"] == 0, f"dected79 tally {n_}")
        codec_launch_check("codec-single-dected79", counts, by_codec, want_codec,
                           {k: want_total[k] for k in counts})
        codec_run["single_dected79"] = {
            "step_056_s": step_s, "scrub_056": scrub, "voltage_steps": steps,
            "agreement_056": float((dtoks[0.56] == dtoks[1.0]).mean())}
        print(f"  single-rail dected79 engine: nominal tokens equal to phase 4's; 0.56 V step "
              f"{step_s:.2f} s, scrub {json.dumps(scrub)}, tokens agree with nominal "
              f"{codec_run['single_dected79']['agreement_056']:.3f}")
        paths_extra["codec-single-dected79"] = {
            "launches": counts, "launches_by_codec": by_codec, "kv_codec": None,
            "matmuls_per_forward": per_fwd,
            "forwards": {"prefill": n_["prefill"], "decode": n_["decode"],
                         "decode_kernel": n_["decode_kernel"]},
            "packs": n_["packs"], "commits": 0, "voltage_steps": steps}
        del deng
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 10
    with Phase("10 traced steps, timings and the kernels line"):
        for name, run in runs.items():
            run["steps"] = step_breakdown(traced_params.pop(name), {"prefill": 0, "decode": 0},
                                          walls=run["steps"])
            for k_, r_ in run["steps"].items():
                if r_["traced_device_events"]:
                    # a decode step's matmuls ran the decode kernel, a
                    # prefill's the tiled one (the trace may drop events, so
                    # no count is required)
                    want_ = "decode" if k_ == "decode" else "tiled"
                    by_k = r_["ecc_matmul_launches_by_kernel"]
                    require(by_k[want_] == r_["ecc_matmul_launches"] > 0,
                            f"{name} {k_} step traced B3 launches {by_k}")
                    print(f"  {name} {k_} step (batch {BATCH}): wall {r_['wall_ms']:.2f} ms; "
                          f"traced: device busy {r_['device_busy_ms']:.2f} ms (idle share "
                          f"{r_['device_idle_share']:.3f}), fused ECC matmuls "
                          f"{r_['ecc_matmul_ms']:.2f} ms in {r_['ecc_matmul_launches']} "
                          f"launches of {b3_names[want_]} (share {r_['ecc_matmul_share']:.3f})")
                else:
                    print(f"  {name} {k_} step (batch {BATCH}): wall {r_['wall_ms']:.2f} ms; "
                          "device time not measured (the profiler traced no device event)")
        for name, run in runs.items():
            step = run["0.56V"]
            kernel = report["inject_scrub_domains" if name == "multi-rail" else "inject_scrub"]
            print(f"  {name}: {run['1.0V']['tokens_per_s']:.1f} tokens/s at nominal "
                  f"(batch {BATCH}, {NEW_TOKENS} new tokens); nominal step "
                  f"{run['1.0V']['step_s']:.3f} s; 0.56 V step {step['step_s']:.2f} s "
                  f"= host masks {step['host_mask_s']:.2f} s + rest "
                  f"{step['step_s'] - step['host_mask_s']:.3f} s (scrub kernel "
                  f"{kernel['ms']:.3f} ms of it)")
        print(f"  runs {json.dumps(runs)}")
        print(f"  paged {json.dumps(paged)}")
        print(f"  fig3 {json.dumps(fig3)}")
        print(f"  per_leaf {json.dumps(per_leaf_run)}")
        print(f"  domain {json.dumps(domain_run)}")
        paths = {**runs, **{k: v for k, v in paged.items() if "launches" in v}, **paths_extra}

        print(f"  codec {json.dumps(codec_run)}")

        def by_path(kernel, kind=None, codec="secded72"):
            """A kernel's launches per path: the fused matmul's split between
            its decode kernel (forward passes of at most DECODE_MAX_M rows)
            and its tiled kernel (the others); a codec-generic kernel's
            launches under ``codec``, the encode's split into its plain form
            and its token-commit form (the commits of a path's kv codec)."""
            if kind in ("decode", "tiled"):
                fwd_ = {p: r["forwards"]["decode_kernel"] if kind == "decode" else
                        r["forwards"]["prefill"] + r["forwards"]["decode"]
                        - r["forwards"]["decode_kernel"] for p, r in paths.items()}
                return {p: paths[p]["matmuls_per_forward"] * f for p, f in fwd_.items()}
            if kernel not in ops.launch_counts_by_codec():
                return {p: r["launches"][kernel] for p, r in paths.items()}
            out = {}
            for p, r in paths.items():
                n = r["launches_by_codec"][kernel].get(codec, 0)
                if kernel == "encode":
                    commits = r["commits"] if r.get("kv_codec", "secded72") == codec else 0
                    n = commits if kind == "commits" else n - commits
                out[p] = n
            return out

        src = "src/repro_torch/kernels/csrc/"
        generic = {  # entry -> (source, reference kernel, kernel, encode form)
            "inject_scrub": ("inject_scrub.cu", "src/repro/kernels/inject_scrub.py:203",
                             "inject_scrub", None),
            "inject_scrub_domains": ("inject_scrub.cu", "src/repro/kernels/inject_scrub.py:239",
                                     "inject_scrub_domains", None),
            "decode": ("secded.cu", "src/repro/kernels/secded.py:92", "decode", None),
            "encode": ("secded.cu", "src/repro/kernels/secded.py:76", "encode", "packs"),
            "encode_commit": ("secded.cu", "src/repro/kernels/secded.py:76", "encode",
                              "commits"),
            "gather_scrub": ("paged_gather.cu", "src/repro/kernels/paged_gather.py:108",
                             "gather_scrub", None),
        }
        meta, kernel_of = {}, {}
        for entry, (source, replaces, kernel, kind) in generic.items():
            for codec in codes.names():
                name = entry if codec == "secded72" else f"{entry}_{codec}"
                meta[name] = (source, replaces, by_path(kernel, kind, codec), codec)
                kernel_of[name] = kernel
        meta.update({
            "ecc_matmul_decode": ("ecc_matmul.cu", "src/repro/kernels/ecc_matmul.py:98",
                                  by_path("ecc_matmul", "decode"), "secded72"),
            "ecc_matmul_prefill": ("ecc_matmul.cu", "src/repro/kernels/ecc_matmul.py:98",
                                   by_path("ecc_matmul", "tiled"), "secded72"),
            "inject": ("fault_inject.cu", "src/repro/kernels/fault_inject.py:25",
                       by_path("inject"), None),
        })
        for p_, r_ in paths.items():  # the two B3 kernels split each path's count
            require(sum(meta[k][2][p_] for k in ("ecc_matmul_decode", "ecc_matmul_prefill"))
                    == r_["launches"]["ecc_matmul"], f"B3 launch split of {p_}")
            for kernel in ops.launch_counts_by_codec():  # the variants split each count
                require(sum(meta[n][2][p_] for n, k in kernel_of.items() if k == kernel)
                        == r_["launches"][kernel], f"{kernel} launch split of {p_}")
        kernels = []
        for name, (source, replaces, launches, codec) in meta.items():
            r = report[name]
            mm = name.startswith("ecc_matmul")
            kernels.append({
                "name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches, "codec": codec,
                "max_abs_err": r.get("max_abs_err", 0.0), "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r.get("bound_by", "bytes"),
                "library_ms": r.get("library_ms"),
                **({"M": r["M"], "per": "one layer's 7 matmuls", "shapes": r["shapes"],
                    "max_rel_err": r["max_rel_err"], "function": r["function"]}
                   if mm else {"n_words": r["n_words"]}),
                **({k: r[k] for k in ("bytes_ms", "ops_ms", "masks", "ms_054", "ms_nominal")
                    if k in r}),
                **({"mlp": r["mlp"]} if "mlp" in r else {}),
            })
        kernels[[k["name"] for k in kernels].index("encode")]["kv_arena"] = report["encode_kv_arena"]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
