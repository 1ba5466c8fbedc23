"""repro_torch.obs — the reliability flight recorder (DESIGN.md §17).

One deterministic, causally-ordered record of what the reliability stack
did and why: typed trace events on a step-clock (never wall-clock), a
metrics registry fed from the existing FaultStats containers, JSONL /
Chrome-trace / markdown exporters, and opt-in wall-clock kernel profiling
hooks kept strictly outside the deterministic event log.

Quick use::

    from repro_torch.obs import TraceRecorder
    rec = TraceRecorder()
    eng = ServingEngine(cfg, params, rel, recorder=rec)
    eng.serve(requests, ...)
    rec.to_jsonl("trace.jsonl")
    rec.to_chrome_trace("trace.json")    # load in Perfetto
    print(rec.summary_markdown())        # or: python -m repro_torch.obs.report
"""

from repro_torch.obs.events import (
    ENVELOPE_FIELDS,
    EVENT_KINDS,
    EventSchemaError,
    validate_event,
    validate_events,
)
from repro_torch.obs.export import (
    read_jsonl,
    summary_markdown,
    to_chrome_trace,
    to_jsonl,
)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.profile import KernelProfiler
from repro_torch.obs.recorder import TraceRecorder

__all__ = [
    "ENVELOPE_FIELDS",
    "EVENT_KINDS",
    "Counter",
    "EventSchemaError",
    "Gauge",
    "Histogram",
    "KernelProfiler",
    "MetricsRegistry",
    "TraceRecorder",
    "read_jsonl",
    "summary_markdown",
    "to_chrome_trace",
    "to_jsonl",
    "validate_event",
    "validate_events",
]
