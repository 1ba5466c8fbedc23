"""Undervolting sweeps: (platform x voltage) grids, per-domain rail schedules
and codec schemes, classified on a zero memory.

Each grid point draws its flip masks with the device fault field
(``DeviceFaultField``, the fault-field kernel on the card) and classifies
them with the fused inject+scrub kernel on a zero memory, as the paper's
hardware test does: a zero word is a codeword of every code, so the masks
are the faulty codeword and the kernel's counter lanes are the outcome
tallies (codes with ``exact_tallies`` count genuine corrections). One field
(its row weakness) serves every point of a grid that shares a platform and
a check width, so the faulty set at a lower voltage is a superset (FIP).

The reference evaluates a grid as one vmapped ``jax.random`` draw; the port
draws a field per point, on the Philox stream of the device field, so its
counters equal the reference's in distribution only. ``dispatch_count``
counts the field draws the sweeps made (one per point and codec whose rate
is not zero; the reference counts one compiled call per chunk).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import codes
from repro_torch.core import scenario
from repro_torch.core.faultsim import DeviceFaultField, zero_masks
from repro_torch.core.telemetry import DomainFaultStats, FaultStats
from repro_torch.core.voltage import PLATFORMS, PlatformProfile
from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device

# Words one inject+scrub launch classifies: its int32 counter lanes then
# hold at most 88 x 2^24 flipped bits, below 2^31.
CLASSIFY_WORDS = 1 << 24
MAX_WORDS = (1 << 31) - 1

_dispatches = {"n": 0}


def reset_dispatch_count() -> None:
    _dispatches["n"] = 0


def dispatch_count() -> int:
    return _dispatches["n"]


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One (platform, voltage) grid point's fault statistics."""

    platform: str
    voltage: float
    stats: FaultStats


def _check_words(n_words: int) -> int:
    n_words = int(n_words)
    if not 0 < n_words <= MAX_WORDS:
        raise ValueError(f"a sweep takes 1 to 2^31 - 1 words, got {n_words}")
    return n_words


def _grid_rates(grid, env) -> np.ndarray:
    """float32 fault rates of the (profile, voltage) points, scaled by the
    environment's flux multiplier."""
    rates = np.array([p.fault_rate(float(v)) for p, v in grid], np.float32)
    if env is not None:
        rates *= np.float32(env.rate_multiplier)
    return rates


def shard_seed(seed: int, shard: int) -> int:
    """The field seed of shard ``shard``: shard 0 keeps ``seed``, every other
    shard keys its own stream."""
    return int(seed) if shard == 0 else int(seed) ^ (int(shard) << 32)


def _draw(field: DeviceFaultField, rates):
    """The field's masks at a scalar rate or a per-word rate tensor; a draw
    of a nonzero rate counts as one dispatch."""
    if isinstance(rates, torch.Tensor) or float(rates) != 0.0:
        _dispatches["n"] += 1
    return field.masks_for_rates(rates)


def _classify(masks, codec: str, dom_ids=None, n_domains: int = 1) -> np.ndarray:
    """Counter rows of ``masks`` on a zero memory under ``codec``: (8,) or,
    with ``dom_ids``, (n_domains, 8), summed in int64 on the host over
    launches of at most ``CLASSIFY_WORDS`` words."""
    n = masks[0].numel()
    dev = masks[0].device
    z = zero_masks(min(n, CLASSIFY_WORDS), codes.get(codec).n_check, dev)
    rows = []
    for a in range(0, n, CLASSIFY_WORDS):
        m = [t[a : a + CLASSIFY_WORDS] for t in masks]
        zz = [t[: m[0].numel()] for t in z]
        if dom_ids is None:
            out = kops.inject_scrub(*zz, *m, codec=codec)
        else:
            out = kops.inject_scrub_domains(*zz, *m, dom_ids[a : a + CLASSIFY_WORDS],
                                            n_domains, codec=codec)
        rows.append(out[3])
    return torch.stack(rows).cpu().numpy().astype(np.int64).sum(axis=0)


def _grid_counters(grid, n_words, seed, env, device, codec="secded72",
                   rate_scale=np.float32(1.0)) -> np.ndarray:
    """(points, 8) int64 counters of a (profile, voltage) grid under one
    codec, each point drawn from its profile's field."""
    rates = _grid_rates(grid, env) * np.float32(rate_scale)
    burst, n_check = scenario.active_burst(env), codes.get(codec).n_check
    fields: dict = {}  # one per platform: its row weakness serves every point
    rows = []
    for (p, _), r in zip(grid, rates):
        if p not in fields:
            fields[p] = DeviceFaultField(p, n_words, seed=seed, n_check=n_check, burst=burst,
                                         device=device)
        rows.append(_classify(_draw(fields[p], float(r)), codec))
    return np.stack(rows)


def sweep_platform_grid(grid, n_words: int, seed: int = 0, env=None,
                        device=None) -> list[SweepPoint]:
    """SECDED fault statistics of a flat (PlatformProfile, voltage) grid, one
    SweepPoint per pair in order. Every point of a platform draws from one
    field keyed by ``seed`` (the device field of the same geometry). ``env``
    (scenario.EnvironmentProfile) scales the rates by its flux and gives
    the field its burst shape; None is the plain sweep. ``device`` None is
    the card."""
    grid = list(grid)
    if not grid:
        return []
    n_words = _check_words(n_words)
    total = _grid_counters(grid, n_words, seed, env, resolve_device(device))
    return [SweepPoint(p.name, float(v), FaultStats.from_counters(total[i], n_words))
            for i, (p, v) in enumerate(grid)]


def sweep_platform_grid_sharded(grid, n_words: int, n_shards: int, seed: int = 0, env=None,
                                age: float = 0.0, device=None) -> list[list[SweepPoint]]:
    """Per-shard (platform, voltage) grids, one sweep per chip: shard 0 on
    the unsharded stream (``sweep_platform_grid`` row for row), shard s > 0
    on a stream of its own (``shard_seed``). Each shard's rates carry the
    environment's flux and its own aging multiplier at soak age ``age``
    (``scenario.aging_multiplier``), so the chips' V_min fan out with the
    soak; without drift every multiplier is 1.0."""
    grid = list(grid)
    if not grid or n_shards <= 0:
        return [[] for _ in range(max(n_shards, 0))]
    n_words = _check_words(n_words)
    dev = resolve_device(device)
    out = []
    for s in range(n_shards):
        mult = np.float32(scenario.aging_multiplier(s, age, env, seed))
        total = _grid_counters(grid, n_words, shard_seed(seed, s), env, dev, rate_scale=mult)
        out.append([SweepPoint(p.name, float(v),
                               FaultStats.from_counters(total[i], n_words, shard=s))
                    for i, (p, v) in enumerate(grid)])
    return out


def shard_vmin_spread(profile, voltages, n_words: int, n_shards: int, seed: int = 0,
                      env=None, age: float = 0.0, device=None) -> list:
    """Per shard, the last voltage of a descending walk over ``voltages``
    before its first DED event (the lock a per-shard rail reaches), or None
    for a shard that detects already at the top voltage (widen the grid)."""
    grid = [(profile, float(v)) for v in voltages]
    out = []
    for points in sweep_platform_grid_sharded(grid, n_words, n_shards, seed=seed, env=env,
                                              age=age, device=device):
        vmin = None
        for pt in points:
            if pt.stats.detected > 0:
                break
            vmin = pt.voltage
        out.append(vmin)
    return out


def sweep_rail_schedules(schedules, domains, dom_ids, profiles, seed: int = 0,
                         device=None) -> list[DomainFaultStats]:
    """SECDED statistics of per-domain rail schedules, one DomainFaultStats
    per schedule.

    ``schedules``: {domain: voltage} mappings; ``domains`` the counter row
    order; ``dom_ids`` the (n_words,) domain index of every arena word (a
    ``PlaneStore``'s ``dom_ids``); ``profiles`` maps domain ->
    PlatformProfile (one profile is broadcast). A schedule gives word w its
    domain's rate in one per-word rate vector of the store's field
    (``seed``, one row weakness: the domains must share their sigma), so a
    schedule's rows equal a device-mask store's telemetry at those rails."""
    schedules = [dict(s) for s in schedules]
    domains = tuple(domains)
    if not schedules:
        return []
    if isinstance(profiles, PlatformProfile):
        profiles = {d: profiles for d in domains}
    sigmas = {profiles[d].row_sigma for d in domains}
    if len(sigmas) != 1:
        raise ValueError(f"an arena shares one row-weakness field, got row sigmas "
                         f"{sorted(sigmas)}")
    dev = resolve_device(device)
    dom = torch.as_tensor(dom_ids).to(dev, torch.int32).reshape(-1)
    n_words = _check_words(dom.numel())
    counts = torch.bincount(dom.to(torch.int64), minlength=len(domains)).cpu().tolist()
    words_by_domain = {d: int(counts[i]) for i, d in enumerate(domains)}
    field = DeviceFaultField(profiles[domains[0]], n_words, seed=seed, device=dev)
    out = []
    for s in schedules:
        rates = np.array([profiles[d].fault_rate(float(s[d])) for d in domains], np.float32)
        if rates.any():
            masks = _draw(field, torch.index_select(torch.from_numpy(rates).to(dev), 0, dom))
        else:
            masks = zero_masks(n_words, field.n_check, dev)
        total = _classify(masks, "secded72", dom, len(domains))
        out.append(FaultStats.from_counter_matrix(total, domains, words_by_domain))
    return out


def sweep_codec_schemes(codec_names, grid, n_words: int, seed: int = 0, env=None,
                        device=None) -> list[dict]:
    """Coverage against check-bit overhead for every (codec, platform,
    voltage): one row dict per (codec, grid point) with the codec's geometry,
    the counters and the coverage fractions. Each codec's points draw from
    fields of its check width, so every scheme is judged on the same weak
    cells; ``env`` adds the flux and the burst shape and tags each row."""
    grid = list(grid)
    rows: list[dict] = []
    if not grid:
        return rows
    n_words = _check_words(n_words)
    dev = resolve_device(device)
    for cname in codec_names:
        codec = codes.get(cname)
        total = _grid_counters(grid, n_words, seed, env, dev, codec=cname)
        for i, (p, v) in enumerate(grid):
            st = FaultStats.from_counters(total[i], n_words)
            rows.append({
                **({} if env is None else {"environment": env.name}),
                "codec": cname,
                "check_bits": codec.n_check,
                "overhead": codec.overhead,
                "platform": p.name,
                "voltage": float(v),
                **st.coverage_row(),
            })
    return rows


def campaign_voltage_grid(profile: PlatformProfile, step: float = 0.02) -> tuple:
    """The accuracy campaign's voltage axis for one platform: nominal (the
    clean anchor), V_min (the last fault-free point), then every ``step``
    volts through the critical region down to the crash rail; descending."""
    grid = [profile.v_nom, profile.v_min]
    v = profile.v_min - step
    while v > profile.v_crash + 1e-9:
        grid.append(round(v, 3))
        v -= step
    grid.append(profile.v_crash)
    return tuple(grid)


def paper_grid():
    """All three paper platforms x their critical-region voltage steps."""
    pairs = []
    for prof in PLATFORMS.values():
        vs = np.round(np.arange(prof.v_crash, prof.v_min + 1e-9, 0.01), 3)
        pairs.extend((prof, float(v)) for v in vs)
    return pairs


def main(argv=None, device=None) -> None:
    """``python -m repro_torch.core.sweep [--out FILE] [--words N] [--seed S]``

    The platform x voltage sweep of the paper's grid over N words, one JSON
    row per point (to stdout, or FILE)."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--out", default=None, help="JSON output path (default stdout)")
    ap.add_argument("--words", type=int, default=512 * 1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    points = sweep_platform_grid(paper_grid(), args.words, seed=args.seed, device=device)
    rows = [
        {
            "platform": p.platform,
            "voltage": p.voltage,
            **p.stats.coverage_row(),
            "coverage": p.stats.coverage(),
            "dispatches": dispatch_count(),
        }
        for p in points
    ]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {len(rows)} sweep points -> {args.out}")
    else:
        json.dump(rows, sys.stdout, indent=1)


if __name__ == "__main__":
    main()
