"""Serve a small LM with batched requests under an undervolted, ECC-protected
weight memory, on the PyTorch/CUDA port.

* Weights are int8-quantized, packed to BRAM word geometry, SECDED-encoded
  (`inline` mode: every matmul runs the fused decode read path).
* The engine scrubs fault telemetry between rounds and the DED-canary
  controller walks the rail down until the first detected-uncorrectable
  event (paper §III/IV runtime undervolting).
* Output-token agreement vs the clean model + modeled power are reported at
  each voltage.

Run: PYTHONPATH=src python examples/torch_serve_lm_ecc.py [--device cpu]
[--share-demo | --trace-demo [DIR] | --mesh-demo] (the default device is
the card; a run without one raises).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.obs import TraceRecorder, read_jsonl, validate_events
from repro_torch.serving import (
    FaultModelConfig,
    ProtectionConfig,
    RailsConfig,
    ReliabilityConfig,
    ServingEngine,
)


def _setup(device):
    cfg = get_smoke_config("qwen3-0.6b")
    params = lm.init_params(cfg, seed=0, device=device)
    return cfg, params, np.random.default_rng(0)


def _stream(prompts):
    return [(prompts[i % 4][: 4 + (3 * i) % 5], 6 + (7 * i) % 13) for i in range(6)]


def serve_main(device=None) -> dict:
    """The per-voltage table, the single-rail and multi-rail locks, the
    paged serve walking its kv rail and the per-domain codecs with their
    escalation ladder; returns the numbers it prints."""
    cfg, params, rng = _setup(device)
    out_: dict = {}
    prompts = rng.integers(0, cfg.vocab, size=(4, 8)).astype(np.int32)

    clean = ServingEngine(cfg, params, rel=None, max_len=64, device=device)
    ref_out = clean.generate(prompts, n_tokens=24)

    print("batched generation under undervolting (inline SECDED weights):")
    print(f"{'V':>5} | {'agree':>6} | {'corrected':>9} | {'detected':>8} | {'power W':>8}")
    out_["table"] = []
    for v in (1.0, 0.58, 0.56, 0.54):
        eng = ServingEngine(
            cfg, params,
            rel=ReliabilityConfig(platform="vc707", ecc=True, voltage=v, mode="inline"),
            max_len=64, device=device,
        )
        out = eng.generate(prompts, n_tokens=24)
        agree = float((out == ref_out).mean())
        s = eng.stats
        print(f"{v:5.2f} | {100 * agree:5.1f}% | {s.corrected:9d} | {s.detected:8d} "
              f"| {eng.power_w():8.2f}")
        out_["table"].append({"v": v, "agree": agree, "corrected": s.corrected,
                              "detected": s.detected, "power_w": eng.power_w()})

    # Runtime undervolting: find the minimum safe voltage via the DED canary.
    eng = ServingEngine(
        cfg, params,
        rel=ReliabilityConfig(platform="vc707", ecc=True, voltage=1.0, mode="inline"),
        max_len=64, device=device,
    )
    v_safe, history = eng.autotune_voltage()
    out = eng.generate(prompts, n_tokens=24)
    agree = float((out == ref_out).mean())
    nominal_w = ServingEngine(cfg, params, rel=ReliabilityConfig(voltage=1.0),
                              device=device).power_w()
    print(
        f"\nDED-canary controller locked at {v_safe:.2f} V after {len(history)} rounds; "
        f"token agreement at locked voltage: {100 * agree:.1f}%; "
        f"accelerator power {eng.power_w():.2f} W (nominal {nominal_w:.2f} W)"
    )
    out_["single_rail"] = {"lock_v": v_safe, "rounds": len(history), "agree": agree,
                           "power_w": eng.power_w(), "nominal_w": nominal_w}

    # Multi-rail: embedding / attention / MLP each walk their own rail down
    # to their own first-DED point. The single rail above had to stop at the
    # weakest domain's trip voltage; the per-domain schedule recovers the
    # rest of the headroom.
    multi = ServingEngine(
        cfg, params,
        rel=ReliabilityConfig(
            platform="vc707", ecc=True, voltage=1.0, mode="inline",
            rails=RailsConfig(multi_rail=True, start_v=0.62),
        ),
        max_len=64, device=device,
    )
    volts, _ = multi.autotune_voltage()
    report = multi.power_report()
    rails = ", ".join(f"{d}={v:.2f}V" for d, v in sorted(volts.items()))
    print(f"\nmulti-rail locks: {rails}")
    print(
        f"BRAM power {report['bram_w'] * 1e3:.0f} mW "
        f"({100 * report['saving_vs_nominal']:.1f}% saving vs nominal; "
        f"single-rail at {v_safe:.2f} V saved "
        f"{100 * eng.power_report()['saving_vs_nominal']:.1f}%)"
    )
    for d, st in multi.rail_stats.by_domain.items():
        print(f"  {d:>10}: corrected={st.corrected} detected={st.detected} "
              f"silent={st.silent} over {st.words} scrubbed words")
    out_["multi_rail"] = {
        "locks": dict(volts), "bram_w": report["bram_w"],
        "saving": report["saving_vs_nominal"],
        "by_domain": {d: st.to_dict() for d, st in multi.rail_stats.by_domain.items()}}

    # Continuous batching over the paged SECDED KV cache: a stream of
    # variable-length requests served on 2 lanes; every token's KV is
    # committed to ECC pages on the `kv` domain, scrubbed on read, and the
    # per-page DED counters walk the kv rail down to its own lock,
    # independent of the weight rails locked above.
    print("\ncontinuous batching on the paged SECDED KV cache:")
    stream = _stream(prompts)
    report = multi.serve(
        stream, n_lanes=2, page_tokens=8, scrub_interval=4,
        walk_kv=True, kv_voltage=0.60,
    )
    kv_rail = multi.controller.rails["kv"]
    print(
        f"served {len(report.outputs)} requests in {report.steps} decode steps "
        f"({report.preemptions} preemptions); kv rail walked "
        f"{report.kv_voltages[0]:.2f} -> {kv_rail.voltage:.2f} V "
        f"({'locked' if kv_rail.locked else 'walking'})"
    )
    for rid in sorted(report.outputs):
        st = report.request_stats[rid]
        toks = report.outputs[rid]
        print(
            f"  req {rid}: prompt={len(stream[rid][0])}t budget={stream[rid][1]}t "
            f"-> {toks[:6].tolist()}{'...' if len(toks) > 6 else ''} "
            f"(cache scrubs: corrected={st.corrected} detected={st.detected})"
        )
    print(
        f"kv cache telemetry: {report.kv_stats.corrected} corrected / "
        f"{report.kv_stats.detected} detected over {report.kv_stats.words} "
        f"scrubbed words; power with kv rail: "
        f"{multi.power_report()['bram_w'] * 1e3:.0f} mW BRAM"
    )
    out_["serve"] = {
        "steps": report.steps, "preemptions": report.preemptions,
        "kv_first_v": report.kv_voltages[0], "kv_v": kv_rail.voltage,
        "kv_locked": kv_rail.locked,
        "outputs": {rid: np.asarray(t).tolist() for rid, t in report.outputs.items()},
        "kv_stats": report.kv_stats.to_dict(),
        "bram_w": multi.power_report()["bram_w"]}

    # Pluggable ECC codecs: a scheme per memory domain (DEC-TED on the MLP
    # arena corrects double-bit faults SECDED can only flag) and an
    # escalation ladder on every rail: on a DED trip the rail steps its code
    # up instead of retreating, then keeps walking. power_report prices the
    # extra check bits ((64 + n_check) / 72 per domain).
    print("\nper-domain ECC codecs + DED-triggered escalation:")
    coded = ServingEngine(
        cfg, params,
        rel=ReliabilityConfig(
            platform="vc707", ecc=True, voltage=1.0, mode="inline",
            fault_model=FaultModelConfig(mask_source="device"),
            rails=RailsConfig(multi_rail=True, start_v=0.62),
            protection=ProtectionConfig(
                codecs={"mlp": "dected79"},
                escalation=("secded72", "ileave88", "dected79"),
            ),
        ),
        max_len=64, device=device,
    )
    volts, hist = coded.autotune_voltage()
    report = coded.power_report()
    out_["codecs"] = {}
    for d in sorted(volts):
        actions = [r.action for r in hist[d]]
        print(
            f"  {d:>10}: locked {volts[d]:.2f} V under {report['codecs'][d]:>9} "
            f"({report['check_bits'][d]:2d} check bits, "
            f"{actions.count('escalate')} escalations)"
        )
        out_["codecs"][d] = {"lock_v": volts[d], "codec": report["codecs"][d],
                             "check_bits": report["check_bits"][d],
                             "escalations": actions.count("escalate")}
    plain_saving = multi.power_report()["saving_vs_nominal"]
    print(
        f"BRAM power {report['bram_w'] * 1e3:.0f} mW incl. redundancy "
        f"({100 * report['saving_vs_nominal']:.1f}% saving vs nominal); "
        f"plain multi-rail saved "
        f"{100 * plain_saving:.1f}%"
    )
    out = coded.generate(prompts, n_tokens=24)
    out_["coded"] = {"bram_w": report["bram_w"], "saving": report["saving_vs_nominal"],
                     "agree": float((out == ref_out).mean())}
    print(f"token agreement at locked rails: {100 * (out == ref_out).mean():.1f}%")
    return out_


def share_demo(device=None) -> dict:
    """Prefix sharing + speculative decode. Run with::

        PYTHONPATH=src python examples/torch_serve_lm_ecc.py --share-demo
    """
    cfg, params, rng = _setup(device)
    eng = ServingEngine(cfg, params, rel=None, max_len=64, device=device)

    # A shared-heavy stream: 8 requests whose prompts share a 24-token prefix
    # (3 full pages at page_tokens=8) plus a private 4-token suffix. The
    # first wave of 2 lanes prefills and registers the prefix pages in the
    # trie; every later admission looks them up, bumps their refcount and
    # prefills only the suffix: the shared pages are physically scrubbed
    # once per interval no matter how many lanes read them.
    prefix = rng.integers(0, cfg.vocab, size=(24,)).astype(np.int32)
    stream = [
        (
            np.concatenate(
                [prefix, rng.integers(0, cfg.vocab, size=(4,)).astype(np.int32)]
            ),
            8,
        )
        for _ in range(8)
    ]
    print("prefix-sharing copy-on-write KV pages:")
    private = eng.serve(stream, n_lanes=2, scrub_interval=4)
    shared = eng.serve(stream, n_lanes=2, scrub_interval=4, share_prefix=True)
    identical = all(
        np.array_equal(private.outputs[r], shared.outputs[r])
        for r in private.outputs
    )
    print(
        f"  served {len(shared.outputs)} requests, "
        f"{shared.prefix_hit_tokens} prompt tokens prefilled from the trie; "
        f"outputs bit-identical to private serve: {identical}"
    )
    assert identical, "shared serve must be bit-identical to private at nominal"

    # Speculative decode: a draft model proposes K tokens per dispatch and
    # the target verifies the whole block in one chunked forward; page
    # commits happen only for accepted tokens. With the target as its own
    # draft every block is fully accepted; emitted tokens are exactly the
    # greedy rollout either way.
    spec = eng.serve(
        stream, n_lanes=2, scrub_interval=4, share_prefix=True,
        speculative=4, draft_params=params, draft_cfg=cfg,
    )
    spec_identical = all(
        np.array_equal(private.outputs[r], spec.outputs[r])
        for r in private.outputs
    )
    print(
        f"speculative decode (K=4, self-draft): {spec.spec_emitted} tokens "
        f"over {spec.spec_dispatches} verify dispatches "
        f"({spec.spec_emitted / max(spec.spec_dispatches, 1):.1f} accepted/block); "
        f"exactly the greedy rollout: {spec_identical}"
    )
    assert spec_identical, "speculative serve must emit exactly the greedy rollout"
    return {"prefix_hit_tokens": shared.prefix_hit_tokens, "shared_identical": identical,
            "spec_emitted": spec.spec_emitted, "spec_dispatches": spec.spec_dispatches,
            "spec_identical": spec_identical,
            "outputs": {r: np.asarray(t).tolist() for r, t in private.outputs.items()}}


def trace_demo(out_dir=None, device=None) -> dict:
    """Reliability flight recorder: serve a small stream with the trace
    recorder attached, then export and validate the run timeline in every
    format, under ``out_dir`` (default: a new temporary directory). Run
    with::

        PYTHONPATH=src python examples/torch_serve_lm_ecc.py --trace-demo [DIR]
    """
    cfg, params, rng = _setup(device)
    rec = TraceRecorder()
    eng = ServingEngine(
        cfg, params,
        rel=ReliabilityConfig(
            platform="vc707", ecc=True, voltage=1.0, mode="inline",
            rails=RailsConfig(multi_rail=True, start_v=0.62),
        ),
        max_len=64, recorder=rec, device=device,
    )
    eng.autotune_voltage(max_rounds=6)  # rail_step / escalation events
    prompts = rng.integers(0, cfg.vocab, size=(4, 8)).astype(np.int32)
    report = eng.serve(
        _stream(prompts), n_lanes=2, page_tokens=8, scrub_interval=4,
        walk_kv=True, kv_voltage=0.60,
    )

    out_dir = out_dir or tempfile.mkdtemp(prefix="repro_trace_")
    os.makedirs(out_dir, exist_ok=True)
    jsonl = os.path.join(out_dir, "trace.jsonl")
    rec.to_jsonl(jsonl)
    n = validate_events(read_jsonl(jsonl))  # schema + causal-order check
    chrome = os.path.join(out_dir, "trace.json")
    rec.to_chrome_trace(chrome)
    with open(chrome) as f:
        ct = json.load(f)
    assert ct["traceEvents"], "chrome trace must not be empty"
    print(
        f"served {len(report.outputs)} requests in {report.steps} steps; "
        f"{n} validated trace events -> {jsonl}"
    )
    print(f"chrome trace ({len(ct['traceEvents'])} entries) -> {chrome}")
    print()
    summary = rec.summary_markdown()
    print(summary)
    return {"requests": len(report.outputs), "steps": report.steps, "events": n,
            "chrome_entries": len(ct["traceEvents"]), "jsonl": jsonl, "chrome": chrome,
            "summary": summary}


def mesh_demo(device=None) -> dict:
    """Mesh-sharded serving: every data-parallel replica is its own chip,
    with its own fault population and its own rails. The mesh takes every
    visible card once (one shard per card); ``--device`` names one device
    for a one-shard mesh. Run with::

        PYTHONPATH=src python examples/torch_serve_lm_ecc.py --mesh-demo
    """
    from repro_torch.launch.mesh import make_reliability_mesh

    mesh = make_reliability_mesh(devices=None if device is None else [device])
    cfg, params, rng = _setup(device)
    n = mesh.shape["data"]
    print(f"mesh serving on {n} reliability shards (policy=per_shard):")
    eng = ServingEngine(
        cfg, params,
        rel=ReliabilityConfig(
            platform="vc707", ecc=True, voltage=1.0, mode="inline",
            fault_model=FaultModelConfig(mask_source="device"),
            rails=RailsConfig(multi_rail=True, policy="per_shard", start_v=0.60),
        ),
        max_len=64, mesh=mesh, device=device,
    )
    schedules, _ = eng.autotune_voltage(max_rounds=12)
    stream = [
        (rng.integers(1, cfg.vocab, size=int(s)).astype(np.int32), int(b))
        for s, b in zip(rng.integers(3, 9, size=3 * n), rng.integers(4, 10, size=3 * n))
    ]
    report = eng.serve(stream, n_lanes=2, scrub_interval=2, walk_kv=True)
    chips = []
    for s in range(n):
        st = report.kv_stats_by_shard[s]
        rails = ", ".join(f"{d[:4]}={v:.2f}" for d, v in sorted(eng.rails[s].items()))
        print(f"  chip {s}: {rails} | kv scrubs corrected={st.corrected} "
              f"detected={st.detected}")
        chips.append({"rails": dict(eng.rails[s]), "corrected": st.corrected,
                      "detected": st.detected})
    pr = eng.power_report()
    print(
        f"served {len(report.outputs)} requests across {n} chips "
        f"({report.steps} dispatch steps, {report.preemptions} preemptions); "
        f"fleet BRAM {pr['bram_w'] * 1e3:.0f} mW, "
        f"{100 * pr['saving_vs_nominal']:.1f}% saving vs nominal"
    )
    return {"n_shards": n, "locks": schedules, "chips": chips,
            "requests": len(report.outputs), "steps": report.steps,
            "preemptions": report.preemptions, "bram_w": pr["bram_w"],
            "saving": pr["saving_vs_nominal"], "shard_of": report.shard_of}


def main(argv=None) -> dict:
    """Parse the flags and run ``serve_main`` or one demo; returns its
    numbers."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--share-demo", action="store_true")
    mode.add_argument("--trace-demo", nargs="?", const="", default=None, metavar="DIR")
    mode.add_argument("--mesh-demo", action="store_true")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.mesh_demo:
        return mesh_demo(args.device)
    if args.share_demo:
        return share_demo(args.device)
    if args.trace_demo is not None:
        return trace_demo(args.trace_demo or None, args.device)
    return serve_main(args.device)


if __name__ == "__main__":
    main()
