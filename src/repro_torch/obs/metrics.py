"""Metrics registry: counters, gauges, histograms (DESIGN.md §17).

Aggregate (end-of-run) views of the quantities the event log records over
time. Everything is plain host Python fed from values the stack already
computes — registering and updating metrics never touches device state, so
a run with metrics is bit-identical to one without.

Metric identity is ``(name, labels)`` where labels is a sorted tuple of
``(key, value)`` pairs — the usual dimensional-metrics model (per-domain /
per-shard rail gauges share a name and differ in labels). ``to_dict()`` is
deterministic (sorted) so two identical runs serialize identically.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.telemetry import COUNTER_FIELDS, FaultStats

#: Default histogram bucket upper bounds (values are engine steps / counts;
#: the last implicit bucket is +inf).
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


@dataclasses.dataclass
class Counter:
    """Monotone event count."""

    value: int = 0

    def inc(self, v: int = 1) -> None:
        assert v >= 0, f"counters are monotone (inc {v})"
        self.value += int(v)

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


@dataclasses.dataclass
class Gauge:
    """Last-set value plus its observed range (min/max/n)."""

    value: float | None = None
    min: float | None = None
    max: float | None = None
    n: int = 0

    def set(self, v) -> None:
        v = float(v)
        self.value = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.n += 1

    def snapshot(self) -> dict:
        return {
            "type": "gauge", "value": self.value,
            "min": self.min, "max": self.max, "n": self.n,
        }


class Histogram:
    """Fixed-bucket histogram with sum/count/min/max."""

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # last = +inf overflow
        self.sum = 0.0
        self.count = 0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, v) -> None:
        v = float(v)
        i = len(self.buckets)
        for j, ub in enumerate(self.buckets):
            if v <= ub:
                i = j
                break
        self.counts[i] += 1
        self.sum += v
        self.count += 1
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {
            "type": "histogram",
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "sum": self.sum, "count": self.count,
            "min": self.min, "max": self.max, "mean": self.mean,
        }


class MetricsRegistry:
    """Name+labels -> metric instance; create-on-first-touch."""

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, name: str, labels: dict, factory):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = factory()
        return m

    def counter(self, name: str, **labels) -> Counter:
        m = self._get(name, labels, Counter)
        assert isinstance(m, Counter), f"{name}: registered as {type(m).__name__}"
        return m

    def gauge(self, name: str, **labels) -> Gauge:
        m = self._get(name, labels, Gauge)
        assert isinstance(m, Gauge), f"{name}: registered as {type(m).__name__}"
        return m

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS, **labels) -> Histogram:
        m = self._get(name, labels, lambda: Histogram(buckets))
        assert isinstance(m, Histogram), f"{name}: registered as {type(m).__name__}"
        return m

    def observe_fault_stats(self, prefix: str, st: FaultStats, **labels) -> None:
        """Fold one FaultStats into ``<prefix>.<counter>`` counters — the
        bridge from the existing telemetry containers. Accepts FaultStats,
        DomainFaultStats (one label set per domain) or ShardFaultStats
        (per shard per domain)."""
        by_shard = getattr(st, "by_shard", None)
        if by_shard is not None:
            for row in by_shard:
                self.observe_fault_stats(prefix, row, **labels)
            return
        by_domain = getattr(st, "by_domain", None)
        if by_domain is not None:
            for d, row in by_domain.items():
                self.observe_fault_stats(prefix, row, domain=d, **labels)
            return
        if st.shard >= 0 and "shard" not in labels:
            labels["shard"] = st.shard
        self.counter(f"{prefix}.words", **labels).inc(st.words)
        for f in COUNTER_FIELDS:
            self.counter(f"{prefix}.{f}", **labels).inc(getattr(st, f))

    def get(self, name: str, **labels):
        """The metric instance, or None if never touched."""
        return self._metrics.get((name, _label_key(labels)))

    def __len__(self) -> int:
        return len(self._metrics)

    def to_dict(self) -> dict:
        """Deterministic {"name{k=v,...}": snapshot} mapping (sorted)."""
        out = {}
        for (name, labels) in sorted(
            self._metrics, key=lambda k: (k[0], str(k[1]))
        ):
            tag = ",".join(f"{k}={v}" for k, v in labels)
            key = f"{name}{{{tag}}}" if tag else name
            out[key] = self._metrics[(name, labels)].snapshot()
        return out
