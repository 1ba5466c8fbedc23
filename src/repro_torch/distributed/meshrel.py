"""The mesh-sharded reliability layer.

At production scale every replica is its own chip with its own silicon, so
its own fault population and its own safe V_min. This module makes the
plane arena and the paged KV cache mesh-native:

  * a codec group's flat planes are padded to a multiple of the shard count
    and cut into one contiguous slice per reliability shard
    (``sharding.reliability_axes``: the data-parallel replica); word ``w``
    lies on shard ``w // local_words``;
  * the rail step (``make_rail_step``) runs, per shard, the fault-field
    kernel under the shard's own stream (``collectives.shard_seed``: shard 0
    keeps the unsharded seed) with a row factor of its own words, then the
    fused inject+scrub (B2) on its slice with its own row of rates. Pad
    words carry the spill domain index and rate 0 and count in no row;
  * the KV scrub step (``make_kv_scrub_step``) runs the paged scrub-on-read
    (B6) over each shard's own arena.

Each shard's slice is a view of the group's padded planes, and B2 writes its
faulty words into a view of one padded output, so a mesh whose shards share
a card gathers nothing: the faulty planes are already where the one-device
decode reads them. A shard on another card gets a copy of its clean slice
there at each step and its faulty slice is copied back, the reference's
gather. Every step is collective-free: the per-shard counter block comes
back as it is, and the one cross-shard sum (``fold_counters``) is the
caller's, once per soak. The F / B2 pair stays per shard: one B2 launch with
shard-offset domain ids would cap the mesh at 16 / n_domains shards (B2
takes at most 16 domains).

The reference's ``arena_sharding`` (a NamedSharding over the shard axes) has
no counterpart beyond these slices.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import codes
from repro_torch.core.faultsim import philox_key, row_factor, zero_masks
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import reliability_axes, reliability_shards
from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import to_device
from repro_torch.obs import profile as obs_profile

__all__ = [
    "fold_counters",
    "make_kv_scrub_step",
    "make_rail_step",
    "pad_to_shards",
    "reliability_axes",
    "reliability_shards",
    "schedule_rates",
]


def fold_counters(per_shard: torch.Tensor) -> torch.Tensor:
    """The once-per-soak counter reduction: an (n_shards, ...) per-shard
    block summed over its shard axis. Call it when a fleet view is needed,
    not per step."""
    return collectives.psum_counters(per_shard)


def pad_to_shards(n: int, n_shards: int) -> int:
    """Padded word count: the smallest multiple of ``n_shards`` >= n."""
    return -(-n // n_shards) * n_shards


@dataclasses.dataclass(frozen=True)
class ShardField:
    """One shard's fault field: its row weakness over its local words and
    its Philox key (a ``DeviceFaultField`` of the shard's seed)."""

    f_row: torch.Tensor
    key: int


def shard_fields(mesh, local_words: int, seed: int, row_sigma: float,
                 base_field=None) -> list:
    """Each shard's field over ``local_words`` words on its device, seeded
    ``collectives.shard_seed(seed, s)`` as a ``DeviceFaultField`` is.
    ``base_field`` (the group's unsharded ``DeviceFaultField``) is reused on
    a one-shard mesh: its words and stream are the shard's."""
    n = reliability_shards(mesh)
    if n == 1 and base_field is not None:
        assert base_field.n_words == local_words, (base_field.n_words, local_words)
        return [ShardField(base_field.f_row, base_field.key)]
    out = []
    for s in range(n):
        key = collectives.shard_seed(seed, s) ^ 0xECC
        out.append(ShardField(row_factor(local_words, float(row_sigma), key, mesh.device_of(s)),
                              philox_key(key)))
    return out


def make_rail_step(mesh, local_words: int, n_domains: int, codec: str, fields, present,
                   reencode: bool = False, burst=None):
    """The per-shard fused inject+scrub step of one codec group.

    Returns ``step(lo, hi, check, dom, rates)`` -> (faulty lo, hi, check,
    per-shard counters (n_shards, n_domains, 8) int32), the planes flat
    (n_shards * local_words,) tensors on one device (the decode's), ``dom``
    every word's domain index (``n_domains`` on pad words) and ``rates`` the
    host (n_shards, n_domains + 1) float32 table of ``schedule_rates``.
    ``fields`` are the shards' fields (``shard_fields``, made once with the
    group's seed and row sigma): shard ``s`` draws its masks from its own
    and runs B2 on its slice into the same slice of the outputs.
    ``present`` (n_shards, n_domains) host booleans marks the domains each
    shard holds: a shard whose present domains all have rate 0 gets zero
    masks without a field launch, as the unsharded store does. The step is
    collective-free: the cross-shard sum is the caller's ``fold_counters``.
    It runs under the dispatch profiler's ``mesh.rail_step`` row."""
    n_shards = reliability_shards(mesh)
    n_check = codes.get(codec).n_check
    present = np.asarray(present, bool)
    assert len(fields) == n_shards, (len(fields), n_shards)
    assert present.shape == (n_shards, n_domains), (present.shape, n_shards, n_domains)
    L = int(local_words)

    def run(lo, hi, check, dom, rates):
        rates = np.asarray(rates, np.float32)
        assert rates.shape == (n_shards, n_domains + 1), (rates.shape, n_shards, n_domains)
        assert lo.numel() == n_shards * L, (lo.numel(), n_shards, L)
        home = lo.device
        olo, ohi, ochk = torch.empty_like(lo), torch.empty_like(hi), torch.empty_like(check)
        counters = []
        for s, field in enumerate(fields):
            dev = mesh.device_of(s)
            cut = slice(s * L, (s + 1) * L)
            views = [t[cut] for t in (olo, ohi, ochk)]
            if dev == home:
                counters.append(_shard_step(field, [t[cut] for t in (lo, hi, check, dom)],
                                            rates[s], present[s], views)[3])
                continue
            with _on(dev):
                local = [t[cut].to(dev) for t in (lo, hi, check, dom)]
                *faulty, cnt = _shard_step(field, local, rates[s], present[s], None)
            for v, f in zip(views, faulty):
                v.copy_(f)
            counters.append(cnt.to(home))
        return olo, ohi, ochk, torch.stack(counters)

    def _shard_step(field, local, rates_s, present_s, out):
        """One shard's F and B2 on its ``local`` (lo, hi, check, dom) slice,
        B2 writing into ``out`` where given: (lo, hi, check, counters)."""
        dev = local[0].device
        if not rates_s[:n_domains][present_s].any():
            masks = zero_masks(L, n_check, dev)
        else:
            masks = kops.fault_field(field.f_row,
                                     torch.index_select(to_device(rates_s, dev), 0, local[3]),
                                     field.key, n_check, burst=burst)
        return kops.inject_scrub_domains(*local[:3], *masks, local[3], n_domains, codec=codec,
                                         reencode=reencode, out=out)

    def step(*args):
        return obs_profile.call("mesh.rail_step", run, *args)

    return step


def _on(dev: torch.device):
    """Make ``dev`` the current card while a shard on another card launches
    its kernels (a kernel runs on the current card's streams)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def make_kv_scrub_step(mesh, words_per_page: int, local_words: int, table_cols: int,
                       codec: str = codes.DEFAULT_CODEC, with_payload: bool = True):
    """The paged scrub-on-read over the shards' KV arenas stacked flat.

    Returns ``step(lo, hi, par, table)``: the planes are the ``n_shards``
    arenas of ``local_words`` words each, stacked flat on one device;
    ``table`` (n_shards, table_cols) holds each shard's page ids, local to
    its arena (its scratch page filling unused columns). Each shard's B6
    gathers and scrubs its own rows and writes the corrected words back into
    its own slice, in place. Returns (lo, hi, par, payload (n_shards,
    table_cols, 2 * words_per_page) float32, counters (n_shards, table_cols,
    8) int32); ``with_payload=False`` drops the payload (a scrub-only soak).
    The reference returns the payload as its two word planes; B6 here gives
    it as the float32 values. The step runs under the dispatch profiler's
    ``mesh.kv_scrub_step`` row."""
    n_shards = reliability_shards(mesh)
    L = int(local_words)

    def run(lo, hi, par, table):
        table = torch.as_tensor(table, dtype=torch.int32)
        assert tuple(table.shape) == (n_shards, table_cols), (tuple(table.shape), n_shards)
        assert lo.numel() == n_shards * L, (lo.numel(), n_shards, L)
        table = table.to(lo.device)
        payloads, counters = [], []
        for s in range(n_shards):
            cut = slice(s * L, (s + 1) * L)
            payload, cnt = kops.gather_scrub_pages(lo[cut], hi[cut], par[cut], table[s],
                                                   words_per_page, codec=codec)
            payloads.append(payload)
            counters.append(cnt)
        out = (lo, hi, par)
        if with_payload:
            out += (torch.stack(payloads),)
        return out + (torch.stack(counters),)

    def step(*args):
        return obs_profile.call("mesh.kv_scrub_step", run, *args)

    return step


def schedule_rates(schedule, domains, profiles, n_shards: int,
                   shard_multipliers=None) -> np.ndarray:
    """(n_shards, n_domains + 1) float32 fault-rate table of a rail schedule.

    ``schedule``: one {domain: voltage} dict (every shard alike) or one per
    shard; ``profiles`` maps domain -> PlatformProfile. The trailing spill
    column is rate 0: pad words never fault and never count.
    ``shard_multipliers`` (n_shards,) scales each chip's row, the per-shard
    aging drift (``scenario.aging_multiplier``); None or all ones gives the
    unscaled table bit for bit."""
    if isinstance(schedule, dict):
        schedule = [schedule] * n_shards
    schedule = list(schedule)
    assert len(schedule) == n_shards, (len(schedule), n_shards)
    rates = np.zeros((n_shards, len(domains) + 1), np.float32)
    for s, volts in enumerate(schedule):
        missing = set(domains) - set(volts)
        assert not missing, f"shard {s} rails missing domains: {sorted(missing)}"
        for i, d in enumerate(domains):
            rates[s, i] = profiles[d].fault_rate(float(volts[d]))
    if shard_multipliers is not None:
        mult = np.asarray(shard_multipliers, np.float32)
        assert mult.shape == (n_shards,), (mult.shape, n_shards)
        rates *= mult[:, None]  # the spill column stays 0.0
    return rates
