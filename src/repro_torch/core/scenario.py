"""Environment scenario matrix: correlated bursts, FIT multipliers, aging drift.

The i.i.d. per-bitplane flip model (core/faultsim.py) is the regime where
every SEC-class code looks alike: doubles are rare and randomly placed, so
``ileave88``/``dected79`` cannot differ from plain SECDED and the escalation
ladder never trips. Reduced-voltage SRAM faults are not i.i.d.: MoRS
(arXiv:2110.05855) measures spatially correlated multi-bit upsets, and the
error-pattern distribution over fault events is roughly

    single 85% | double-adjacent 12% | triple-adjacent 2% | random-double 1%

Three knobs, bundled per named environment:

  * **BurstProfile**: the multi-bit-upset shape. Each base i.i.d. faulty bit
    is a burst anchor: with probability ``double_adjacent`` it extends to
    the next higher bitplane, with ``triple_adjacent`` the next two, with
    ``random_double`` it drags one uniformly placed extra bit of its word
    along, and with ``word_adjacent`` it repeats at the same bitplane of the
    next word. The class draw per anchor position does not depend on the
    voltage, so FIP survives: the anchors at V' < V are a superset, their
    promotions are fixed per position, hence so is the expanded set.
    ``expand_bursts`` is the host field's expansion (numpy); the fault-field
    kernel (kernels/csrc/fault_field.cu) expands the device field's anchors
    in the same launch that draws them.
  * **rate_multiplier**: FIT-style flux scaling of the fault curve
    (consumer 1x, avionics 300x, space 50000x), applied by scaling
    (rate_crash, rate_floor) together: ``fault_rate(v)`` is multiplied
    uniformly below V_min, the guardband and the slope k stay.
  * **aging drift**: a deterministic per-chip lognormal rate multiplier
    ``exp(drift_sigma * z_s * age / drift_tau)``, ``z_s`` a hash-derived
    standard normal per chip; drift_sigma = 0 makes every multiplier exactly
    1.0.

Pure configuration and pure functions: no RNG state, no device memory. The
numbers equal the reference's (src/repro/core/scenario.py) float for float.
"""

from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np

from repro_torch.core.voltage import PlatformProfile, _erfinv

__all__ = [
    "ENVIRONMENTS",
    "MBU_DISTRIBUTION",
    "BurstProfile",
    "EnvironmentProfile",
    "active_burst",
    "aging_multiplier",
    "expand_bursts",
    "resolve",
    "scenario_voltage",
    "shard_aging_z",
]


@dataclasses.dataclass(frozen=True)
class BurstProfile:
    """Correlated multi-bit-upset shape: per-anchor promotion probabilities.

    All-zero (the default) means pure i.i.d. — the fault fields skip the
    expansion entirely, so the historical stream is reproduced bit-for-bit.
    The three class probabilities are disjoint fractions of one uniform draw
    per anchor position and must sum to <= 1.
    """

    double_adjacent: float = 0.0  # anchor extends 1 bitplane down
    triple_adjacent: float = 0.0  # anchor extends 2 bitplanes down
    random_double: float = 0.0  # anchor drags one random extra bit of its word
    word_adjacent: float = 0.0  # anchor repeats at the next word, same bitplane

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            assert 0.0 <= v <= 1.0, (f.name, v)
        assert (
            self.double_adjacent + self.triple_adjacent + self.random_double
        ) <= 1.0 + 1e-9, "anchor class fractions must sum to <= 1"

    @property
    def enabled(self) -> bool:
        return (
            self.double_adjacent > 0.0
            or self.triple_adjacent > 0.0
            or self.random_double > 0.0
            or self.word_adjacent > 0.0
        )

    @property
    def needs_class_draw(self) -> bool:
        return (
            self.double_adjacent + self.triple_adjacent + self.random_double
        ) > 0.0

    def class_thresholds(self) -> tuple[float, float, float]:
        """Cumulative thresholds (triple, triple+double, +random_double) for
        the single uniform class draw per anchor position."""
        p3 = self.triple_adjacent
        p2 = p3 + self.double_adjacent
        prd = p2 + self.random_double
        return p3, p2, prd


def _shift_planes(a, k: int, xp):
    """Shift a (n_bitplanes, m) bool matrix ``k`` bitplanes down (toward
    higher plane index), truncating at the codeword edge — a burst anchored
    in the top check bitplane has nowhere to extend."""
    z = xp.zeros((k,) + a.shape[1:], dtype=bool)
    return xp.concatenate([z, a[:-k]], axis=0)


def _shift_words(a, k: int, xp):
    """Shift along the word axis (column clustering), truncating at the
    chunk edge — chunk geometry is part of the deterministic stream layout,
    exactly like the per-chunk PRNG fold."""
    z = xp.zeros(a.shape[:1] + (k,), dtype=bool)
    return xp.concatenate([z, a[:, :-k]], axis=1)


def expand_bursts(
    faulty, burst: BurstProfile, class_u=None, word_u=None, extra_bit=None, xp=np
):
    """Expand i.i.d. anchors into correlated bursts. Pure and xp-generic.

    ``faulty``: (n_bitplanes, m) bool anchor matrix (the base i.i.d. draw).
    ``class_u``/``word_u``: (n_bitplanes, m) uniforms in [0, 1);
    ``extra_bit``: (m,) int bitplane index for the random-double companion.
    Draws gated off by a zero probability may be None. Returns the expanded
    bool matrix (a superset of ``faulty``: expansion ORs, never XORs, so a
    promotion landing on an already-faulty cell stays faulty — monotone in
    the anchor set, which is what preserves FIP).

    ``xp`` is the array namespace (numpy for the host field); the device
    field's kernel and its plain version compute the same OR of shifted
    anchor sets from their own draws.
    """
    if not burst.enabled:
        return faulty
    p3, p2, prd = burst.class_thresholds()
    out = faulty
    if p2 > 0.0:
        ext1 = faulty & (class_u < p2)  # extends >= 1 plane (double or triple)
        out = out | _shift_planes(ext1, 1, xp)
        if p3 > 0.0:
            ext2 = faulty & (class_u < p3)  # extends 2 planes (triple)
            out = out | _shift_planes(ext2, 2, xp)
    if burst.random_double > 0.0:
        rd = faulty & (class_u >= p2) & (class_u < prd)
        sel = xp.any(rd, axis=0)  # word has a random-double anchor
        nb = faulty.shape[0]
        onehot = (xp.arange(nb)[:, None] == extra_bit[None, :]) & sel[None, :]
        out = out | onehot
    if burst.word_adjacent > 0.0:
        col = faulty & (word_u < burst.word_adjacent)
        out = out | _shift_words(col, 1, xp)
    return out


# ---------------------------------------------------------------------------
# Environments
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EnvironmentProfile:
    """One row of the scenario matrix: flux, burst shape, aging drift."""

    name: str
    rate_multiplier: float = 1.0  # FIT-style flux multiplier on the curve
    burst: BurstProfile = BurstProfile()
    drift_sigma: float = 0.0  # per-chip aging spread (lognormal sigma at t=tau)
    drift_tau: float = 100.0  # soak intervals to reach one drift_sigma

    def scale_profile(self, profile: PlatformProfile) -> PlatformProfile:
        """Env-scaled fault curve: multiply (rate_crash, rate_floor) by the
        flux multiplier. Scaling both keeps the slope k — the whole curve
        below V_min shifts by exactly ``rate_multiplier``; the guardband
        (rate 0 above V_min) and V_crash are silicon properties and stay."""
        if self.rate_multiplier == 1.0:
            return profile
        return dataclasses.replace(
            profile,
            name=f"{profile.name}@{self.name}",
            rate_crash=profile.rate_crash * self.rate_multiplier,
            rate_floor=profile.rate_floor * self.rate_multiplier,
        )


# The MoRS-style measured error-pattern distribution (SNIPPETS): 12% of fault
# events extend to the adjacent bit, 2% to two adjacent bits, 1% drag a
# random second bit — on top of the 85% singles.
MBU_DISTRIBUTION = BurstProfile(
    double_adjacent=0.12,
    triple_adjacent=0.02,
    random_double=0.01,
    word_adjacent=0.04,
)

# FIT-style flux multipliers: terrestrial consumer baseline, avionics flight
# altitude (~300x neutron flux), space orbit (~5e4x, heavy-ion dominated with
# larger multi-bit clusters and faster aging).
ENVIRONMENTS = {
    "consumer": EnvironmentProfile(
        "consumer", 1.0, MBU_DISTRIBUTION, drift_sigma=0.05, drift_tau=200.0
    ),
    "avionics": EnvironmentProfile(
        "avionics",
        300.0,
        dataclasses.replace(MBU_DISTRIBUTION, word_adjacent=0.08),
        drift_sigma=0.10,
        drift_tau=150.0,
    ),
    "space": EnvironmentProfile(
        "space",
        50000.0,
        BurstProfile(
            double_adjacent=0.16,
            triple_adjacent=0.04,
            random_double=0.02,
            word_adjacent=0.12,
        ),
        drift_sigma=0.20,
        drift_tau=100.0,
    ),
}


def resolve(env, drift: float | None = None) -> EnvironmentProfile | None:
    """None / name / EnvironmentProfile -> EnvironmentProfile (or None).

    ``drift`` overrides the environment's ``drift_sigma`` when given; a bare
    ``drift`` with ``env=None`` yields a neutral environment (multiplier 1,
    i.i.d. bursts) carrying only the drift — the isolation knob the
    divergence tests use.
    """
    if env is None:
        if drift is None:
            return None
        return EnvironmentProfile("neutral", drift_sigma=float(drift))
    if isinstance(env, str):
        assert env in ENVIRONMENTS, (env, sorted(ENVIRONMENTS))
        env = ENVIRONMENTS[env]
    if drift is not None:
        env = dataclasses.replace(env, drift_sigma=float(drift))
    return env


def active_burst(x) -> BurstProfile | None:
    """The burst a fault stream expands: ``x`` an ``EnvironmentProfile``, a
    ``BurstProfile`` or None; a disabled profile (i.i.d. flips) is None."""
    burst = x.burst if isinstance(x, EnvironmentProfile) else x
    return burst if (burst is not None and burst.enabled) else None


# ---------------------------------------------------------------------------
# Per-shard aging drift
# ---------------------------------------------------------------------------
def shard_aging_z(shard: int, seed: int = 0) -> float:
    """Deterministic standard-normal aging slope for one chip — the
    derive_domain_profiles hash pattern, keyed by (seed, shard) so the slope
    is a property of the silicon sample, not of when it is asked."""
    h = zlib.crc32(f"aging:{seed}:{shard}".encode()) / 0xFFFFFFFF
    h = min(max(h, 1e-9), 1.0 - 1e-9)
    return math.sqrt(2.0) * _erfinv(2.0 * h - 1.0)


def aging_multiplier(
    shard: int, age: float, env: EnvironmentProfile | None, seed: int = 0
) -> float:
    """Fault-rate multiplier of chip ``shard`` after ``age`` soak intervals.

    ``exp(drift_sigma * z_shard * age / drift_tau)``: chips fan out
    lognormally as the soak progresses. Exactly 1.0 when env is None,
    drift_sigma == 0, or age <= 0 — the drift=0 collapse the divergence
    tests pin.
    """
    if env is None or env.drift_sigma <= 0.0 or age <= 0.0:
        return 1.0
    t = float(age) / float(env.drift_tau)
    return math.exp(env.drift_sigma * shard_aging_z(shard, seed) * t)


def scenario_voltage(
    profile: PlatformProfile,
    env: EnvironmentProfile | None,
    target_rate: float = 1e-4,
) -> float:
    """The voltage where the env-scaled fault rate reaches ``target_rate``.

    Environments shift the whole curve by their flux multiplier, so a fixed
    voltage compares codecs at wildly different fault densities (space is
    P_MAX-saturated at VC707's deepest step). This picks the operating point
    with comparable density per environment — bisection on the env-scaled
    ``fault_rate`` (monotone below V_min), clamped into (V_crash, V_min).
    """
    mult = env.rate_multiplier if env is not None else 1.0
    lo, hi = profile.v_crash, profile.v_min - 1e-4
    if mult * profile.fault_rate(lo) <= target_rate:
        return round(lo, 4)
    if mult * profile.fault_rate(hi) >= target_rate:
        return round(hi, 4)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if mult * profile.fault_rate(mid) > target_rate:
            lo = mid  # too deep: rate too high -> move up
        else:
            hi = mid
    return round(0.5 * (lo + hi), 4)
