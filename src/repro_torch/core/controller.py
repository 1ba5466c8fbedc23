"""Application-aware runtime undervolting controller (paper §III.A / §IV).

Because of the Fault Inclusion Property, correctable faults appear before
detectable ones, which appear before undetectable ones. The DED
(detected-but-uncorrectable) flag of the built-in ECC is therefore a safe
canary: keep lowering the rail while reads are clean or corrected; on the
first DED event back off one step and lock. With ``paranoid=True`` silent
events (ground truth only, seen in simulation) trip too.

Escalation: an ``EscalationPolicy`` gives a rail a second degree of freedom.
On a DED trip with a stronger code left on its ladder, the rail steps up its
ECC scheme (e.g. SECDED -> DEC-TED) and keeps descending from the same
voltage: the DED events that tripped it are the double-bit class the
stronger code corrects. Once the ladder is spent, the next trip backs off and
locks as before. The caller applies a change (``pop_codec_change``) to the
protected storage before the next interval.

Accuracy canary: the DED counters see detectable corruption, not output
quality. A controller with a ``divergence_slo`` also takes each interval's
canary divergence (the canary prompts' greedy output against the clean
nominal rollout, in [0, 1]); a score above the SLO trips the rail as a DED
event does (escalate where the ladder has a rung left, else back off and
lock), even with every counter at zero.
"""

from __future__ import annotations

import dataclasses

from repro_torch.codes import DEFAULT_CODEC
from repro_torch.configs import shapes
from repro_torch.core.telemetry import DomainFaultStats, FaultStats
from repro_torch.core.voltage import PlatformProfile


@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    """Codec ladder of a DED-canary rail, weakest to strongest.

    ``ded_rate``: the DED events per scrubbed word a trip must exceed to
    escalate; a trip at or below it backs off instead. The default 0.0
    escalates on any DED event while the ladder has a rung left. The kv rail
    is judged on reader-weighted counters (``reader_weighted_stats``), so
    shared pages cross the threshold sooner."""

    ladder: tuple = (DEFAULT_CODEC, "dected79")
    ded_rate: float = 0.0

    def next_codec(self, current: str) -> str | None:
        """The rung above ``current`` (None at or past the top, or off the
        ladder)."""
        if current not in self.ladder:
            return None
        i = self.ladder.index(current)
        return self.ladder[i + 1] if i + 1 < len(self.ladder) else None


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
    shard: int = -1  # the mesh shard whose canary was judged (-1: unsharded)
    divergence: float = 0.0  # the interval's canary divergence (0.0 without one)


class UndervoltController:
    """DED-canary voltage search: V_nom -> first DED, then back off + lock,
    or step up the code where ``escalation`` has a rung left.

    With a flight recorder bound (``bind_recorder``), every ``update``
    mirrors its ControllerRecord as a ``rail_step`` event, an escalation
    adds a ``codec_escalate`` event and a divergence above the SLO a
    ``canary_trip`` event.
    """

    def __init__(
        self,
        platform: PlatformProfile,
        step_v: float = 0.01,
        backoff_steps: int = 1,
        paranoid: bool = False,
        start_v: float | None = None,
        escalation: EscalationPolicy | None = None,
        codec: str | None = None,
        adaptive: bool = False,
        shard: int = -1,
        domain: str | None = None,
        divergence_slo: float | None = None,
    ):
        self.platform = platform
        self.divergence_slo = divergence_slo
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
        self.escalation = escalation
        self.codec = codec or (escalation.ladder[0] if escalation else DEFAULT_CODEC)
        self._pending_codec: str | None = None

    def pop_codec_change(self) -> str | None:
        """The codec escalated to since the last poll (None otherwise). The
        caller applies it to the protected storage
        (``PlaneStore.set_domain_codec``, ``KVPageArena.change_codec``)
        before the next interval."""
        change, self._pending_codec = self._pending_codec, None
        return change

    def bind_recorder(self, recorder) -> None:
        """Attach a flight recorder (obs.TraceRecorder)."""
        self.recorder = recorder

    def update(self, stats: FaultStats, divergence: float | None = None) -> float:
        """Feed one read-interval's telemetry and, optionally, its canary
        ``divergence`` (a score above ``divergence_slo`` trips the rail);
        returns the next rail voltage."""
        acc_trip = (divergence is not None and self.divergence_slo is not None
                    and divergence > self.divergence_slo)
        ded_trip = stats.detected > 0 or (self.paranoid and stats.silent > 0)
        trip = ded_trip or acc_trip
        stronger = self.escalation.next_codec(self.codec) if self.escalation else None
        ded_rate = stats.detected / max(stats.words, 1)
        codec_before = self.codec
        if self.locked:
            if self.adaptive and trip:
                self.voltage = min(
                    self.platform.v_nom, self.voltage + self.backoff_steps * self.step_v
                )
                action = "drift+backoff"
            else:
                action = "hold"
        elif trip and stronger is not None and (
                acc_trip or (stats.detected > 0 and ded_rate > self.escalation.ded_rate)):
            # Step the code up instead of retreating: the voltage holds and
            # the walk resumes under the stronger code next interval. A
            # divergence above the SLO escalates whatever the DED rate.
            self.codec = stronger
            self._pending_codec = stronger
            action = "escalate"
        elif trip:
            self.voltage = min(
                self.platform.v_nom, self.voltage + self.backoff_steps * self.step_v
            )
            self.locked = True
            action = "acc+backoff" if acc_trip and not ded_trip else "trip+backoff"
        else:
            nxt = self.voltage - self.step_v
            if nxt < self.platform.v_crash:
                # Never cross the crash rail; lock at the last operable point.
                self.locked = True
                action = "floor"
            else:
                self.voltage = nxt
                action = "lower"
        div = 0.0 if divergence is None else float(divergence)
        self.history.append(
            ControllerRecord(
                self.voltage, stats.corrected, stats.detected, stats.silent, action, self.codec,
                self.shard, div,
            )
        )
        rec = self.recorder
        if rec:
            # The event carries the very counters that caused the decision.
            rec.emit(
                "rail_step", domain=self.domain, shard=self.shard,
                action=action, voltage=float(self.voltage), codec=self.codec,
                corrected=int(stats.corrected), detected=int(stats.detected),
                silent=int(stats.silent), words=int(stats.words), divergence=div,
            )
            rec.metrics.counter(
                "rail.actions", domain=self.domain or "", action=action, shard=self.shard,
            ).inc()
            if action == "escalate":
                rec.emit(
                    "codec_escalate", domain=self.domain, shard=self.shard,
                    codec_from=codec_before, codec_to=self.codec,
                    ded_rate=ded_rate, acc_trip=bool(acc_trip),
                )
            if acc_trip:
                rec.emit(
                    "canary_trip", domain=self.domain, shard=self.shard,
                    divergence=div, slo=float(self.divergence_slo),
                )
        return self.voltage


class MultiRailController:
    """One DED canary per memory domain: each domain's rail walks down and
    locks independently; converged when every rail is locked. A bound
    flight recorder reaches every rail, late-bound ones too. ``shard`` tags
    every rail with the mesh shard it judges (-1: unsharded)."""

    def __init__(
        self,
        platform: PlatformProfile,
        domains,
        step_v: float = 0.01,
        backoff_steps: int = 1,
        paranoid: bool = False,
        start_v: float | None = None,
        profiles: dict | None = None,
        escalation: EscalationPolicy | None = None,
        codecs: dict | None = None,
        shard: int = -1,
        adaptive: bool = False,
        divergence_slo: float | None = None,
    ):
        profiles = profiles or {}
        codecs = codecs or {}
        self.domains = tuple(domains)
        assert self.domains, "MultiRailController needs at least one domain"
        self._platform = platform
        self.shard = int(shard)
        self._defaults = dict(
            step_v=step_v, backoff_steps=backoff_steps, paranoid=paranoid,
            start_v=start_v, escalation=escalation, shard=shard, adaptive=adaptive,
            divergence_slo=divergence_slo,
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
        the new rail takes the controller's step, backoff, paranoia and
        escalation ladder and starts its own DED-canary walk. Returns the rail's controller."""
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

    def pop_codec_changes(self) -> dict:
        """{domain: codec} escalated since the last poll; the caller applies
        them to the protected stores before the next interval."""
        out = {}
        for d, c in self.rails.items():
            change = c.pop_codec_change()
            if change:
                out[d] = change
        return out

    def update(self, stats, divergence=None) -> dict:
        """Feed one interval's per-domain telemetry (DomainFaultStats or
        {domain: FaultStats}; domains without telemetry hold) and its canary
        ``divergence``: a scalar goes to every rail (the canary runs the
        whole model, so no one domain can be blamed), a {domain: score} dict
        to the rails it names. Returns the next {domain: voltage} schedule."""
        by_domain = getattr(stats, "by_domain", stats)
        div_of = divergence.get if isinstance(divergence, dict) else lambda _d: divergence
        for d, ctrl in self.rails.items():
            if d in by_domain:
                ctrl.update(by_domain[d], divergence=div_of(d))
        return self.voltages


RAIL_POLICIES = ("uniform", "per_shard")


class MeshRailController:
    """Rail control across a mesh of chips, each with its own fault
    population and so its own V_min. Two policies:

      * ``uniform``: one MultiRailController fed the cross-shard sum of the
        per-domain counters, so any shard's DED event trips the shared
        schedule: the fleet locks at the worst shard's V_min, one voltage
        per domain;
      * ``per_shard``: one MultiRailController per shard, each fed its own
        shard's rows, so every chip walks to its own first DED.

    On a one-shard mesh both are the single MultiRailController's walk."""

    def __init__(self, platform: PlatformProfile, domains, n_shards: int,
                 policy: str = "uniform", **defaults):
        self.policy = shapes.rail_policy(policy)
        assert n_shards >= 1, n_shards
        self.n_shards = int(n_shards)
        self.domains = tuple(domains)
        if policy == "uniform":
            self.shards = [MultiRailController(platform, domains, **defaults)]
        else:
            self.shards = [MultiRailController(platform, domains, shard=s, **defaults)
                           for s in range(self.n_shards)]

    def shard(self, s: int) -> MultiRailController:
        """The controller judging shard ``s`` (the shared one under
        ``uniform``)."""
        return self.shards[0] if self.policy == "uniform" else self.shards[s]

    def bind_recorder(self, recorder) -> None:
        """Attach a flight recorder to every shard's controller."""
        for c in self.shards:
            c.bind_recorder(recorder)

    def add_rail(self, domain: str, profile=None, codec=None) -> list:
        """Attach a late-bound rail (the `kv` cache) on every shard's
        controller; returns one rail per shard (under ``uniform`` the one
        shared rail in every entry)."""
        if domain not in self.domains:
            self.domains = self.domains + (domain,)
        return [self.shard(s).add_rail(domain, profile, codec) for s in range(self.n_shards)]

    @property
    def locked(self) -> bool:
        return all(c.locked for c in self.shards)

    def locked_for(self, domains) -> bool:
        return all(c.rails[d].locked for c in self.shards for d in domains)

    @property
    def voltages(self) -> list:
        """Per-shard {domain: voltage} schedule (n_shards entries)."""
        return [dict(self.shard(s).voltages) for s in range(self.n_shards)]

    @property
    def history(self) -> dict:
        """{(shard, domain): [ControllerRecord]} of every rail walked; the
        shared walk of ``uniform`` under shard -1."""
        if self.policy == "uniform":
            return {(-1, d): recs for d, recs in self.shards[0].history.items()}
        return {(s, d): recs for s, c in enumerate(self.shards) for d, recs in c.history.items()}

    @property
    def codecs(self) -> dict:
        """{domain: codec} of shard 0's controller: a mesh store carries one
        codec per domain."""
        return dict(self.shards[0].codecs)

    def pop_codec_changes(self) -> dict:
        """Escalations since the last poll (``uniform`` only: the store
        applies them to every shard)."""
        assert self.policy == "uniform", "per-shard codec escalation needs per-shard plane groups"
        return self.shards[0].pop_codec_changes()

    def update(self, stats, divergence=None) -> list:
        """Feed one interval's mesh telemetry; returns the next per-shard
        schedule.

        ``stats``: a ShardFaultStats, a list of DomainFaultStats (one per
        shard) or, under ``uniform`` only, one DomainFaultStats already
        reduced across shards. ``divergence``: a scalar canary score for
        every shard, or one score per shard (``uniform`` takes their
        maximum)."""
        by_shard = getattr(stats, "by_shard", stats)
        if self.policy == "uniform":
            if isinstance(divergence, (list, tuple)):
                divergence = max((d for d in divergence if d is not None), default=None)
            reduced = by_shard if hasattr(by_shard, "by_domain") else DomainFaultStats.summed(
                by_shard)
            self.shards[0].update(reduced, divergence=divergence)
        else:
            assert not hasattr(by_shard, "by_domain"), (
                "per_shard policy needs per-shard telemetry rows")
            assert len(by_shard) == self.n_shards, (len(by_shard), self.n_shards)
            if not isinstance(divergence, (list, tuple)):
                divergence = [divergence] * self.n_shards
            for s, st in enumerate(by_shard):
                self.shards[s].update(st, divergence=divergence[s])
        return self.voltages
