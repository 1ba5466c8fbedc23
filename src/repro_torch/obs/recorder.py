"""The reliability flight recorder (DESIGN.md §17).

One ``TraceRecorder`` rides through a whole run — engine construction,
rail autotuning, one or many serve streams, campaigns — collecting typed
events (obs/events.py) on a deterministic monotonic step-clock and feeding
a ``MetricsRegistry``. The clock advances on *logical* progress only
(decode dispatch steps, scrub intervals, autotune rounds — never
wall-clock), so two identical runs produce byte-identical traces and a
trace diff is a behaviour diff.

Instrumented call sites hold an ``Optional[TraceRecorder]`` and guard with
plain truthiness (``if rec: rec.emit(...)``) — the disabled path is one
``is not None``-equivalent check, no object construction, no allocation,
and bit-identical numerics (the recorder only ever *reads* host values the
stack already computed).
"""

from __future__ import annotations

from repro_torch.obs.events import EVENT_KINDS, validate_event
from repro_torch.obs.metrics import MetricsRegistry


class TraceRecorder:
    """Append-only typed event log + metrics on a deterministic step-clock.

    ``strict=True`` (default) validates every event against the schema at
    emit time — emission sites are few and host-side, so the cost is noise
    and a malformed event fails at the source instead of at export.
    """

    def __init__(self, strict: bool = True, profiler=None):
        self.events: list[dict] = []
        self.step = 0
        self.metrics = MetricsRegistry()
        self.strict = strict
        # Optional obs.profile.KernelProfiler. Wall-clock rows live on the
        # profiler, NOT in the event log — the log must stay deterministic.
        self.profiler = profiler

    def __bool__(self) -> bool:  # `if rec:` guards at instrumented sites
        return True

    def __len__(self) -> int:
        return len(self.events)

    # -- the step clock -----------------------------------------------------
    def advance(self, n: int = 1) -> int:
        """Advance the logical clock by ``n`` steps (n >= 0); returns it."""
        assert n >= 0, n
        self.step += int(n)
        return self.step

    # -- emission -----------------------------------------------------------
    def emit(
        self,
        kind: str,
        *,
        shard: int = -1,
        domain: str | None = None,
        request_id: int | None = None,
        **payload,
    ) -> dict:
        """Append one event at the current step; returns the event dict."""
        ev = {
            "seq": len(self.events),
            "step": self.step,
            "kind": kind,
            "shard": int(shard),
            "domain": domain,
            "request_id": None if request_id is None else int(request_id),
            **payload,
        }
        if self.strict:
            validate_event(ev)
        self.events.append(ev)
        return ev

    # -- queries (report/test helpers) --------------------------------------
    def of_kind(self, *kinds: str) -> list[dict]:
        for k in kinds:
            assert k in EVENT_KINDS, k
        want = set(kinds)
        return [e for e in self.events if e["kind"] in want]

    def shards(self) -> list[int]:
        return sorted({e["shard"] for e in self.events})

    # -- exports (thin delegates; see obs/export.py) ------------------------
    def to_jsonl(self, path=None) -> str:
        from repro_torch.obs import export

        return export.to_jsonl(self, path)

    def to_chrome_trace(self, path=None) -> dict:
        from repro_torch.obs import export

        return export.to_chrome_trace(self, path)

    def summary_markdown(self) -> str:
        from repro_torch.obs import export

        return export.summary_markdown(self)
