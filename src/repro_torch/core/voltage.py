"""Voltage rail model: fault-rate curves, power model, platform profiles.

Calibrated to the paper's measured anchors:

  * V_nom = 1.0 V; no faults at or above V_min (the guardband).
  * Fault rate grows exponentially from ~0 at V_min to R_crash at V_crash.
  * VC707 R_crash = 652 faults/Mbit; KC705-A = 4.1x KC705-B.
  * BRAM power (no ECC): 2.4 W @ 1.0 V, 0.31 W @ 0.61 V, 0.198 W @ 0.54 V,
    fitted exactly by P(V) = a*exp(b*V) + c.
  * ECC adds 13 mW at 0.54 V, scaled ~V^2.
  * Accelerator: P_total = P_bram + P_rest, with P_rest chosen so the
    nominal->crash saving is the paper's 25.2%.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import zlib

MBIT = 1024 * 1024.0


@dataclasses.dataclass(frozen=True)
class PlatformProfile:
    """Undervolting behaviour of one physical FPGA sample (paper Fig. 1)."""

    name: str
    v_nom: float
    v_min: float  # minimum safe voltage (guardband floor)
    v_crash: float  # lowest operational voltage
    rate_crash: float  # observed faults per bit at v_crash
    rate_floor: float  # rate at v_min
    row_sigma: float  # lognormal per-row weakness (fault clustering)

    @property
    def guardband(self) -> float:
        return 1.0 - self.v_min / self.v_nom

    @property
    def k(self) -> float:
        """Exponential slope of the fault-rate curve (per volt)."""
        return math.log(self.rate_crash / self.rate_floor) / (self.v_min - self.v_crash)

    def fault_rate(self, v: float) -> float:
        """Per-bit fault probability at rail voltage ``v``: zero at or above
        v_min, exponential below, clamped at the crash rate."""
        if v >= self.v_min:
            return 0.0
        v = max(v, self.v_crash)
        return self.rate_crash * math.exp(-self.k * (v - self.v_crash))

    def faults_per_mbit(self, v: float) -> float:
        """Expected faulty bits per Mbit (2^20 bits) at rail voltage ``v``."""
        return self.fault_rate(v) * MBIT


# Tested memory in the paper: 512 x (1024 x 64-bit) words (+8 parity).
_TESTED_BITS = 512 * 1024 * 72.0

PLATFORMS = {
    "vc707": PlatformProfile(
        name="vc707", v_nom=1.0, v_min=0.61, v_crash=0.54,
        rate_crash=652.0 / MBIT, rate_floor=1.0 / _TESTED_BITS, row_sigma=1.40,
    ),
    "kc705a": PlatformProfile(
        name="kc705a", v_nom=1.0, v_min=0.605, v_crash=0.53,
        rate_crash=150.0 / MBIT, rate_floor=1.0 / _TESTED_BITS, row_sigma=1.40,
    ),
    "kc705b": PlatformProfile(
        name="kc705b", v_nom=1.0, v_min=0.615, v_crash=0.53,
        rate_crash=150.0 / 4.1 / MBIT, rate_floor=1.0 / _TESTED_BITS, row_sigma=1.40,
    ),
}

_P_ANCHORS = ((0.54, 0.198), (0.61, 0.31), (1.0, 2.4))  # paper Table I(b), no ECC
ECC_POWER_AT_CRASH_W = 0.013


@functools.lru_cache(maxsize=None)
def _fit_power() -> tuple:
    """Fit P(V) = a*exp(b*V) + c exactly through the three paper anchors."""
    (v1, p1), (v2, p2), (v3, p3) = _P_ANCHORS

    def resid(b: float) -> float:
        return (p3 - p2) / (p2 - p1) - (
            (math.exp(b * v3) - math.exp(b * v2)) / (math.exp(b * v2) - math.exp(b * v1))
        )

    lo_b, hi_b = 0.1, 30.0
    for _ in range(200):
        mid = 0.5 * (lo_b + hi_b)
        if resid(lo_b) * resid(mid) <= 0:
            hi_b = mid
        else:
            lo_b = mid
    b = 0.5 * (lo_b + hi_b)
    a = (p2 - p1) / (math.exp(b * v2) - math.exp(b * v1))
    c = p1 - a * math.exp(b * v1)
    return a, b, c


def bram_power(v: float, ecc: bool = False) -> float:
    """BRAM rail power (W) at voltage ``v`` (paper Table I)."""
    a, b, c = _fit_power()
    p = a * math.exp(b * v) + c
    if ecc:
        p += ECC_POWER_AT_CRASH_W * (v / 0.54) ** 2
    return p


_P_TOTAL_NOM = (bram_power(1.0) - 0.211) / 0.252
P_REST_W = _P_TOTAL_NOM - bram_power(1.0)


def accelerator_power(v: float, ecc: bool = True) -> float:
    """Total NN-accelerator power (W) with the BRAM rail at ``v`` (paper
    §IV)."""
    return P_REST_W + bram_power(v, ecc=ecc)


def power_saving(v_from: float, v_to: float, ecc: bool = False) -> float:
    """Fractional BRAM power saving when undervolting v_from -> v_to."""
    p0, p1 = bram_power(v_from, ecc=False), bram_power(v_to, ecc=ecc)
    return 1.0 - p1 / p0


def derive_domain_profiles(
    base: PlatformProfile, domains, spread: float = 0.5, seed: int = 0
) -> dict:
    """Per-domain profiles: each domain's fault-rate curve scaled by a
    lognormal instance factor (E[f] = 1, deterministic in (seed, domain)),
    keeping the base silicon's guardband and crash rail."""
    out = {}
    for d in domains:
        h = zlib.crc32(f"{seed}:{d}".encode()) / 0xFFFFFFFF
        z = math.sqrt(2.0) * _erfinv(2.0 * h - 1.0)
        f = math.exp(spread * z - 0.5 * spread * spread)
        out[d] = dataclasses.replace(
            base, name=f"{base.name}/{d}", rate_crash=base.rate_crash * f
        )
    return out


def _erfinv(x: float) -> float:
    """Scalar inverse error function (Winitzki approximation, |err|<2e-3)."""
    a = 0.147
    ln1mx2 = math.log(max(1.0 - x * x, 1e-30))
    t = 2.0 / (math.pi * a) + ln1mx2 / 2.0
    return math.copysign(math.sqrt(math.sqrt(t * t - ln1mx2 / a) - t), x)


def redundancy_factor(n_check: int) -> float:
    """Array-size scale of a code with ``n_check`` check bits vs the
    measured 72-bit BRAM word."""
    return (64 + int(n_check)) / 72.0


def multi_rail_bram_power(
    volts: dict, words_by_domain: dict, ecc: bool = True,
    check_bits: dict | None = None,
) -> float:
    """Total BRAM power (W) with each domain's rail at its own voltage; a
    domain draws its word share of the curve at its rail."""
    total = max(sum(words_by_domain.values()), 1)
    check_bits = check_bits or {}
    return sum(
        (words_by_domain[d] / total)
        * bram_power(float(v), ecc=ecc)
        * redundancy_factor(check_bits.get(d, 8))
        for d, v in volts.items()
        if d in words_by_domain
    )


def multi_rail_power_saving(
    volts: dict, words_by_domain: dict, ecc: bool = True, v_nom: float = 1.0,
    check_bits: dict | None = None,
) -> float:
    """Fractional BRAM saving of a per-domain schedule vs the nominal rail."""
    p0 = bram_power(v_nom, ecc=False)
    return 1.0 - multi_rail_bram_power(
        volts, words_by_domain, ecc=ecc, check_bits=check_bits
    ) / p0


# -- the mesh: every reliability shard is its own chip ------------------------
def mesh_bram_power(schedules, words_by_shard, ecc: bool = True,
                    check_bits: dict | None = None) -> float:
    """Total BRAM power (W) across a mesh of chips: ``schedules`` one
    {domain: voltage} schedule per shard, ``words_by_shard`` the matching
    {domain: words} dicts. Each chip draws the calibrated P(V) curve at its
    own rails; the rails are per-chip supplies, so the total is the plain
    sum."""
    assert len(schedules) == len(words_by_shard), (len(schedules), len(words_by_shard))
    return sum(multi_rail_bram_power(v, w, ecc=ecc, check_bits=check_bits)
               for v, w in zip(schedules, words_by_shard))


def mesh_power_saving(schedules, words_by_shard, ecc: bool = True, v_nom: float = 1.0,
                      check_bits: dict | None = None) -> float:
    """Fleet-level fractional BRAM saving against every chip at the nominal
    rail (n_shards x one chip's nominal draw)."""
    p0 = len(schedules) * bram_power(v_nom, ecc=False)
    return 1.0 - mesh_bram_power(schedules, words_by_shard, ecc=ecc,
                                 check_bits=check_bits) / max(p0, 1e-30)
