"""Trace exporters: JSONL, Chrome trace-event JSON, markdown summary.

JSONL is the canonical archival format — one event per line, sorted keys,
no whitespace variance — so byte-equality of two logs is semantic equality
of two runs (the determinism contract tests/test_obs.py pins).

The Chrome trace export loads in Perfetto / chrome://tracing: one process
("track") per mesh shard, threads for the scheduler, per-request lifetime
spans, the kv scrub cadence and each voltage rail; gauges become counter
tracks. The trace ``ts`` axis is the deterministic step-clock (1 step ==
1 "microsecond" — logical time, not wall time).
"""

from __future__ import annotations

import json

#: Fixed thread-track ids inside each shard's process track.
TID_SERVE = 0
TID_REQUESTS = 1
TID_KV = 2
TID_RAIL_BASE = 10  # + sorted-domain index


def event_lines(recorder_or_events) -> list[str]:
    events = getattr(recorder_or_events, "events", recorder_or_events)
    return [
        json.dumps(ev, sort_keys=True, separators=(",", ":"))
        for ev in events
    ]


def to_jsonl(recorder_or_events, path=None) -> str:
    """Serialize to JSONL (one event per line); write to ``path`` if given."""
    text = "\n".join(event_lines(recorder_or_events))
    if text:
        text += "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def read_jsonl(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _pid(shard: int) -> int:
    return shard + 1  # shard -1 (unsharded/global) -> pid 0


def to_chrome_trace(recorder_or_events, path=None) -> dict:
    """Chrome trace-event JSON with per-shard tracks (Perfetto-loadable)."""
    events = getattr(recorder_or_events, "events", recorder_or_events)
    shards = sorted({e["shard"] for e in events})
    domains = sorted({e["domain"] for e in events if e["domain"] is not None})
    tid_of_domain = {d: TID_RAIL_BASE + i for i, d in enumerate(domains)}
    out: list[dict] = []
    for s in shards:
        pid = _pid(s)
        name = "global" if s < 0 else f"shard {s}"
        out.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": name},
        })
        for tid, tname in (
            (TID_SERVE, "serve"), (TID_REQUESTS, "requests"), (TID_KV, "kv"),
        ):
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
        for d in domains:
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": tid_of_domain[d], "args": {"name": f"rail:{d}"},
            })
    admit_step: dict = {}  # (shard, rid) -> first admission step
    for ev in events:
        pid = _pid(ev["shard"])
        kind = ev["kind"]
        args = {
            k: v for k, v in ev.items()
            if k not in ("seq", "step", "kind", "shard")
        }
        if kind == "gauge":
            out.append({
                "ph": "C", "name": ev["name"], "ts": ev["step"], "pid": pid,
                "args": {"value": ev["value"]},
            })
            continue
        if kind == "admit":
            admit_step.setdefault((ev["shard"], ev["request_id"]), ev["step"])
        if kind == "retire":
            t0 = admit_step.get(
                (ev["shard"], ev["request_id"]),
                ev["step"] - ev["latency_steps"],
            )
            out.append({
                "ph": "X", "name": f"req {ev['request_id']}", "ts": t0,
                "dur": max(ev["step"] - t0, 1), "pid": pid,
                "tid": TID_REQUESTS, "args": args,
            })
        if ev["domain"] is not None and kind in (
            "rail_step", "codec_escalate", "canary_trip"
        ):
            tid = tid_of_domain[ev["domain"]]
        elif kind in ("kv_scrub", "kv_codec_change", "shared_ded_recovery"):
            tid = TID_KV
        else:
            tid = TID_SERVE
        out.append({
            "ph": "i", "name": kind, "ts": ev["step"], "pid": pid,
            "tid": tid, "s": "t", "args": args,
        })
        if kind == "rail_step":
            out.append({
                "ph": "C", "name": f"V[{ev['domain']}]", "ts": ev["step"],
                "pid": pid, "args": {"value": ev["voltage"]},
            })
    trace = {"traceEvents": out, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f, sort_keys=True)
    return trace


# -- markdown run summary ----------------------------------------------------

def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def summary_markdown(recorder_or_events) -> str:
    """Human-readable run summary (the `python -m repro_torch.obs.report` body)."""
    events = getattr(recorder_or_events, "events", recorder_or_events)
    metrics = getattr(recorder_or_events, "metrics", None)
    lines = ["# Reliability flight-recorder summary", ""]
    if not events:
        lines.append("_empty trace_")
        return "\n".join(lines) + "\n"
    shards = sorted({e["shard"] for e in events})
    lines += [
        f"- events: **{len(events)}**, final step-clock: "
        f"**{events[-1]['step']}**",
        f"- shards: {', '.join(str(s) for s in shards)}",
        "",
        "## Event counts",
        "",
        "| kind | count |",
        "|---|---|",
    ]
    counts: dict = {}
    for e in events:
        counts[e["kind"]] = counts.get(e["kind"], 0) + 1
    for k in sorted(counts):
        lines.append(f"| {k} | {counts[k]} |")

    rails = [e for e in events if e["kind"] == "rail_step"]
    if rails:
        lines += [
            "", "## Rail trajectories", "",
            "| shard | domain | steps | V first | V last | codec last "
            "| trips | escalations |",
            "|---|---|---|---|---|---|---|---|",
        ]
        by_rail: dict = {}
        for e in rails:
            by_rail.setdefault((e["shard"], e["domain"]), []).append(e)
        for (s, d), evs in sorted(by_rail.items(), key=str):
            trips = sum(
                1 for e in evs
                if "backoff" in e["action"] or e["action"] == "floor"
            )
            esc = sum(1 for e in evs if e["action"] == "escalate")
            lines.append(
                f"| {s} | {d} | {len(evs)} | {_fmt(evs[0]['voltage'])} "
                f"| {_fmt(evs[-1]['voltage'])} | {evs[-1]['codec']} "
                f"| {trips} | {esc} |"
            )

    scrubs = [e for e in events if e["kind"] == "kv_scrub"]
    if scrubs:
        det = sum(e["detected"] for e in scrubs)
        cor = sum(e["corrected"] for e in scrubs)
        sil = sum(e["silent"] for e in scrubs)
        lines += [
            "", "## KV scrub",
            "",
            f"- intervals: {len(scrubs)}, corrected: {cor}, detected: {det}, "
            f"silent: {sil}",
            f"- final kv voltage: "
            f"{_fmt(scrubs[-1]['voltage'])} V ({scrubs[-1]['codec']})",
        ]

    retires = [e for e in events if e["kind"] == "retire"]
    if retires:
        lat = [e["latency_steps"] for e in retires]
        lines += [
            "", "## Requests", "",
            f"- finished: {len(retires)}, mean latency: "
            f"{_fmt(sum(lat) / len(lat))} steps, max: {max(lat)}",
        ]
        pre = sum(e["preemptions"] for e in retires)
        if pre:
            lines.append(f"- preemptions experienced: {pre}")
    specs = [e for e in events if e["kind"] == "spec_block"]
    if specs:
        slots = sum(e["slots"] for e in specs)
        emitted = sum(e["emitted"] for e in specs)
        lines += [
            "", "## Speculative decode", "",
            f"- dispatches: {len(specs)}, emitted {emitted}/{slots} "
            f"slots (acceptance {_fmt(emitted / max(slots, 1))})",
        ]

    if metrics is not None and len(metrics):
        lines += [
            "", "## Metrics", "",
            "| metric | value |",
            "|---|---|",
        ]
        for name, snap in metrics.to_dict().items():
            if snap["type"] == "counter":
                val = _fmt(snap["value"])
            elif snap["type"] == "gauge":
                val = (
                    f"{_fmt(snap['value'])} "
                    f"(min {_fmt(snap['min'])}, max {_fmt(snap['max'])})"
                )
            else:
                val = (
                    f"mean {_fmt(snap['mean'])}, n {snap['count']}, "
                    f"max {_fmt(snap['max'])}"
                )
            lines.append(f"| `{name}` | {val} |")

    profiler = getattr(recorder_or_events, "profiler", None)
    if profiler is not None and profiler.rows:
        lines += ["", profiler.summary_markdown()]
    return "\n".join(lines) + "\n"
