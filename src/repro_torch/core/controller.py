"""Application-aware runtime undervolting controller (paper §III.A / §IV).

Because of the Fault Inclusion Property, correctable faults appear before
detectable ones, which appear before undetectable ones. The DED
(detected-but-uncorrectable) flag of the built-in ECC is therefore a safe
canary: keep lowering the rail while reads are clean or corrected; on the
first DED event back off one step and lock. With ``paranoid=True`` silent
events (ground truth only, seen in simulation) trip too.
"""

from __future__ import annotations

import dataclasses

from repro_torch.codes import DEFAULT_CODEC
from repro_torch.core.telemetry import FaultStats
from repro_torch.core.voltage import PlatformProfile


def reader_weighted_stats(weighted: FaultStats, physical: FaultStats) -> FaultStats:
    """Reader-weighted counters over the physical word population.

    ``weighted`` counts a shared page's events once per reader; ``physical``
    is the deduplicated scrub truth (each page once). The kv rail is judged
    on weighted events over physical words, so a DED on a page with N
    readers counts N times. Without sharing this is the identity."""
    return FaultStats.from_counters(weighted.counters(), words=physical.words, shard=physical.shard)


@dataclasses.dataclass
class ControllerRecord:
    voltage: float
    corrected: int
    detected: int
    silent: int
    action: str
    codec: str = DEFAULT_CODEC


class UndervoltController:
    """DED-canary voltage search: V_nom -> first DED, then back off + lock.

    Codec escalation is not ported: ``escalation`` must be None. With a
    flight recorder bound (``bind_recorder``), every ``update`` mirrors its
    ControllerRecord as a ``rail_step`` event.
    """

    def __init__(
        self,
        platform: PlatformProfile,
        step_v: float = 0.01,
        backoff_steps: int = 1,
        paranoid: bool = False,
        start_v: float | None = None,
        escalation=None,
        codec: str | None = None,
        adaptive: bool = False,
        shard: int = -1,
        domain: str | None = None,
    ):
        if escalation is not None:
            raise NotImplementedError("codec escalation is not ported")
        self.platform = platform
        self.step_v = step_v
        self.backoff_steps = backoff_steps
        self.paranoid = paranoid
        self.adaptive = adaptive
        self.shard = int(shard)
        self.domain = domain  # rail name when owned by a MultiRailController
        self.recorder = None  # optional obs.TraceRecorder
        # Warm start anywhere in the fault-free guardband [v_min, v_nom].
        self.voltage = (
            platform.v_nom if start_v is None
            else min(platform.v_nom, max(float(start_v), platform.v_min))
        )
        self.locked = False
        self.history: list[ControllerRecord] = []
        self.codec = codec or DEFAULT_CODEC

    def bind_recorder(self, recorder) -> None:
        """Attach a flight recorder (obs.TraceRecorder)."""
        self.recorder = recorder

    def update(self, stats: FaultStats) -> float:
        """Feed one read-interval's telemetry; returns the next rail voltage."""
        trip = stats.detected > 0 or (self.paranoid and stats.silent > 0)
        if self.locked:
            if self.adaptive and trip:
                self.voltage = min(
                    self.platform.v_nom, self.voltage + self.backoff_steps * self.step_v
                )
                action = "drift+backoff"
            else:
                action = "hold"
        elif trip:
            self.voltage = min(
                self.platform.v_nom, self.voltage + self.backoff_steps * self.step_v
            )
            self.locked = True
            action = "trip+backoff"
        else:
            nxt = self.voltage - self.step_v
            if nxt < self.platform.v_crash:
                # Never cross the crash rail; lock at the last operable point.
                self.locked = True
                action = "floor"
            else:
                self.voltage = nxt
                action = "lower"
        self.history.append(
            ControllerRecord(
                self.voltage, stats.corrected, stats.detected, stats.silent, action, self.codec
            )
        )
        rec = self.recorder
        if rec:
            # The event carries the very counters that caused the decision.
            rec.emit(
                "rail_step", domain=self.domain, shard=self.shard,
                action=action, voltage=float(self.voltage), codec=self.codec,
                corrected=int(stats.corrected), detected=int(stats.detected),
                silent=int(stats.silent), words=int(stats.words), divergence=0.0,
            )
            rec.metrics.counter(
                "rail.actions", domain=self.domain or "", action=action, shard=self.shard,
            ).inc()
        return self.voltage


class MultiRailController:
    """One DED canary per memory domain: each domain's rail walks down and
    locks independently; converged when every rail is locked. A bound
    flight recorder reaches every rail, late-bound ones too."""

    def __init__(
        self,
        platform: PlatformProfile,
        domains,
        step_v: float = 0.01,
        backoff_steps: int = 1,
        paranoid: bool = False,
        start_v: float | None = None,
        profiles: dict | None = None,
        escalation=None,
        codecs: dict | None = None,
        adaptive: bool = False,
    ):
        profiles = profiles or {}
        codecs = codecs or {}
        self.domains = tuple(domains)
        assert self.domains, "MultiRailController needs at least one domain"
        self._platform = platform
        self._defaults = dict(
            step_v=step_v, backoff_steps=backoff_steps, paranoid=paranoid,
            start_v=start_v, escalation=escalation, adaptive=adaptive,
        )
        self.recorder = None
        self.rails = {
            d: UndervoltController(
                profiles.get(d, platform), codec=codecs.get(d), domain=d, **self._defaults
            )
            for d in self.domains
        }

    def bind_recorder(self, recorder) -> None:
        """Attach a flight recorder to every rail (late-bound rails added
        through ``add_rail`` inherit it)."""
        self.recorder = recorder
        for c in self.rails.values():
            c.bind_recorder(recorder)

    def add_rail(self, domain: str, profile: PlatformProfile | None = None,
                 codec: str | None = None) -> UndervoltController:
        """Attach a late-bound rail (the `kv` cache once it exists). Idempotent;
        the new rail takes the controller's step, backoff and paranoia and
        starts its own DED-canary walk. Returns the rail's controller."""
        if domain not in self.rails:
            self.domains = self.domains + (domain,)
            self.rails[domain] = UndervoltController(
                profile or self._platform, codec=codec, domain=domain, **self._defaults
            )
            if self.recorder is not None:
                self.rails[domain].bind_recorder(self.recorder)
        return self.rails[domain]

    @property
    def locked(self) -> bool:
        return all(c.locked for c in self.rails.values())

    @property
    def voltages(self) -> dict:
        return {d: c.voltage for d, c in self.rails.items()}

    @property
    def history(self) -> dict:
        return {d: c.history for d, c in self.rails.items()}

    @property
    def codecs(self) -> dict:
        return {d: c.codec for d, c in self.rails.items()}

    def update(self, stats) -> dict:
        """Feed one interval's per-domain telemetry (DomainFaultStats or
        {domain: FaultStats}; domains without telemetry hold). Returns the
        next {domain: voltage} schedule."""
        by_domain = getattr(stats, "by_domain", stats)
        for d, ctrl in self.rails.items():
            if d in by_domain:
                ctrl.update(by_domain[d])
        return self.voltages
