"""Opt-in dispatch profiling hooks (DESIGN.md §17).

Wall-clock is the one thing the deterministic trace must never contain, so
profiling rows live here, beside the recorder rather than inside it. A
``KernelProfiler`` is installed globally (``enable()``); instrumented
dispatch sites route through :func:`call`, which is a single module-global
``None`` check when profiling is off: the hot path pays nothing and the
dispatch result is returned untouched either way.

When profiling is on, a dispatch whose result lies on the card is timed
with a pair of CUDA events on the current stream, and the host waits for
the end event (launches are asynchronous: without the wait the device time
would land on whoever synchronizes next); a dispatch on CPU tensors is
timed with the host clock. Each row is tagged with what ran
(:func:`backend_tag`): ``cuda`` where the wrappers launched their kernels,
``plain`` where they ran their plain PyTorch versions.

Besides the timing rows, the profiler carries *gauges*: wall-clock-derived
scalars that are observations about overlap/efficiency rather than per-call
latencies, e.g. ``serve.scrub_overlap_frac``, the fraction of each deferred
scrub's dispatch-to-counters-ready window that decode blocks covered
(DESIGN.md §18). They live here and not in the recorder's metrics for the
same reason the timing rows do.
"""

from __future__ import annotations

import time

import torch


class KernelProfiler:
    """Aggregating per-dispatch time rows for named dispatch sites."""

    def __init__(self):
        self.rows: dict[str, dict] = {}
        self.gauges: dict[str, dict] = {}

    def record_gauge(self, name: str, value: float) -> None:
        """Observe one wall-clock-derived scalar (running mean + last +
        min/max), e.g. the §18 scrub overlap fraction."""
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = {
                "name": name, "n": 0, "sum": 0.0,
                "last": 0.0, "min": None, "max": None,
            }
        v = float(value)
        g["n"] += 1
        g["sum"] += v
        g["last"] = v
        g["min"] = v if g["min"] is None else min(g["min"], v)
        g["max"] = v if g["max"] is None else max(g["max"], v)

    def gauge_rows(self) -> list[dict]:
        return [
            {**g, "mean": g["sum"] / max(g["n"], 1)}
            for _, g in sorted(self.gauges.items())
        ]

    def record(self, name: str, ms: float, backend: str = "plain") -> None:
        row = self.rows.get(name)
        if row is None:
            row = self.rows[name] = {
                "name": name, "calls": 0, "total_ms": 0.0,
                "min_ms": None, "max_ms": 0.0, "backend": backend,
            }
        row["calls"] += 1
        row["total_ms"] += ms
        row["min_ms"] = ms if row["min_ms"] is None else min(row["min_ms"], ms)
        row["max_ms"] = max(row["max_ms"], ms)

    def to_rows(self) -> list[dict]:
        """BENCH-shaped rows (sorted by name, mean included)."""
        return [
            {**r, "mean_ms": r["total_ms"] / max(r["calls"], 1)}
            for _, r in sorted(self.rows.items())
        ]

    def summary_markdown(self) -> str:
        lines = [
            "## Kernel profile (wall-clock)", "",
            "| dispatch | backend | calls | mean ms | min ms | max ms |",
            "|---|---|---|---|---|---|",
        ]
        for r in self.to_rows():
            lines.append(
                f"| {r['name']} | {r['backend']} | {r['calls']} "
                f"| {r['mean_ms']:.3f} | {r['min_ms']:.3f} "
                f"| {r['max_ms']:.3f} |"
            )
        if self.gauges:
            lines += [
                "", "| gauge | n | mean | last | min | max |",
                "|---|---|---|---|---|---|",
            ]
            for g in self.gauge_rows():
                lines.append(
                    f"| {g['name']} | {g['n']} | {g['mean']:.3f} "
                    f"| {g['last']:.3f} | {g['min']:.3f} | {g['max']:.3f} |"
                )
        return "\n".join(lines) + "\n"


_ACTIVE: KernelProfiler | None = None


def _tensors(obj):
    """The tensors of a dispatch result (nested tuples, lists and dicts),
    depth first."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def backend_tag(result=None) -> str:
    """``cuda`` when ``kernels/backend.dispatch`` launches the kernels for
    the tensors of ``result`` (they lie on the card), else ``plain``."""
    from repro_torch.kernels import backend as _backend

    t = next(_tensors(result), None)
    return "cuda" if t is not None and _backend.dispatch(t) == "cuda" else "plain"


def gauge(name: str, value: float) -> None:
    """Record a wall-clock-derived gauge on the active profiler (no-op, one
    global ``None`` check, when profiling is off)."""
    if _ACTIVE is not None:
        _ACTIVE.record_gauge(name, value)


def enable(profiler: KernelProfiler | None = None) -> KernelProfiler:
    """Install (and return) the active profiler."""
    global _ACTIVE
    _ACTIVE = profiler or KernelProfiler()
    return _ACTIVE


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> KernelProfiler | None:
    return _ACTIVE


def call(name: str, fn, *args, **kwargs):
    """Dispatch ``fn(*args, **kwargs)``, profiled when a profiler is active.

    The off path is one global ``None`` check. The on path brackets the
    dispatch with CUDA events when its result lies on the card and waits
    for the end event, so the row measures the device work it brackets;
    on the CPU it reads the host clock around the call."""
    if _ACTIVE is None:
        return fn(*args, **kwargs)
    start = None
    if torch.cuda.is_available():
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    tag = backend_tag(out)
    if tag == "cuda":
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        ms = (time.perf_counter() - t0) * 1e3
    _ACTIVE.record(name, ms, tag)
    return out
