"""Deterministic per-bitcell failure-threshold field (undervolting fault model).

Every bitcell *i* has a latent uniform draw ``u_i`` (numpy Philox keyed by
(seed, word-chunk)) and every word a lognormal weakness ``f_w`` (E[f] = 1).
At rail voltage V the cell is faulty iff ``u_i < clip(rate(V) * f_w, 0,
P_MAX)``. ``rate`` falls with V and ``u_i`` is fixed, so the faulty set at a
lower voltage is a superset (the paper's Fault Inclusion Property).

``FaultField`` is the host numpy stream of the reference fault model, bit
for bit. Two shortcuts keep it identical: at ``fault_rate(v) == 0`` (at or
above V_min) no draw is made and the masks are zero, since ``u < 0`` is
never true; and ``gather_masks`` draws the chunks of many fields on a
thread pool (numpy's generators and elementwise ops release the GIL), each
chunk from its own counter-keyed generator, so the order of work does not
matter.

``DeviceFaultField`` draws the same model on the card, in one launch of the
fault-field kernel (kernels/csrc/fault_field.cu): a word's row weakness is
drawn once per field by ``torch.randn`` and kept, and bit b of word w flips
iff output b % 4 of Philox4x32-10 at counter (w, b // 4) is below
``uint32(clip(rate f_w, 0, P_MAX) 2^32)``. The masks never exist on the
host.

Both fields take an optional ``burst`` (core/scenario.BurstProfile) that
expands each faulty bit (an anchor) into a correlated multi-bit upset from
draws that do not depend on the voltage, so FIP still holds. The host field
draws them after its base uniforms from the same chunk generator, as the
reference does; the device field's kernel draws them from Philox counters of
their own in the same launch. A disabled profile is ``None``: the stream is
the burst-free one bit for bit. The reference draws its device field with JAX's threefry, which no
torch generator reproduces, so the device streams equal the reference's (and
the host field's) in distribution only; the host field stays the default
and the parity oracle. ``interval_masks``, the paged KV cache's
per-interval draw, is one such field per interval.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os

import numpy as np
import torch

from repro_torch.codes.base import as_words, check_dtypes, narrow, popcount32, widen
from repro_torch.core.scenario import BurstProfile, active_burst, expand_bursts
from repro_torch.core.voltage import PlatformProfile
from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device, to_device

P_MAX = 0.5  # per-bit fault probability ceiling
N_DATA_BITS = 64
N_CHECK_DEFAULT = 8  # SECDED(72,64)
# The bit stream's Philox key is its generator seed XOR this constant, so on
# the card it never replays the Philox stream of torch's own generator.
PHILOX_KEY_SALT = 0xD1B54A32D192ED03


@dataclasses.dataclass(frozen=True)
class FlipMasks:
    """Read-time XOR masks for a (n_words,) memory at one voltage."""

    lo: np.ndarray  # (n,) uint32 — flips in data bits 0..31
    hi: np.ndarray  # (n,) uint32 — flips in data bits 32..63
    parity: np.ndarray  # (n,) uint8 or uint32 (> 8 check bits) — flips in the check bits

    def flip_counts(self) -> np.ndarray:
        """Ground-truth number of flipped bits per codeword."""
        cnt = _popcount32(self.lo) + _popcount32(self.hi)
        return (cnt + _popcount32(self.parity.astype(np.uint32))).astype(np.int32)

    def total_flips(self) -> int:
        return int(self.flip_counts().sum())


def flip_counts(mlo: torch.Tensor, mhi: torch.Tensor, mcheck: torch.Tensor) -> torch.Tensor:
    """Ground-truth flipped bits per codeword of mask tensors (int32 lo/hi
    bit patterns, a uint8 or int32 check plane), on their device (int64)."""
    return popcount32(widen(mlo)) + popcount32(widen(mhi)) + popcount32(mcheck.to(torch.int64))


def device_masks(field: "FaultField", v: float, device, shape=None):
    """The field's (lo int32, hi int32, check) masks at rail voltage ``v``
    as tensors on ``device``, shaped ``shape`` (default flat); the check
    mask is uint8 or int32 as ``check_dtypes(field.n_check)``. At a zero
    fault rate they are zeros made on the device: no draw, no copy. A drawn
    field's kept masks are reused, so a caller can draw many fields at once
    with ``gather_masks`` first."""
    shape = (field.n_words,) if shape is None else tuple(shape)
    if field.platform.fault_rate(float(v)) == 0.0:
        return tuple(t.reshape(shape) for t in zero_masks(field.n_words, field.n_check, device))
    m = field.masks(v)
    return tuple(to_device(as_words(a).reshape(shape), device) for a in (m.lo, m.hi, m.parity))


def _popcount32(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32).copy()
    v = v - ((v >> 1) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
    v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> 24).astype(np.int64)


def _zero_masks(n: int, n_check: int = N_CHECK_DEFAULT) -> FlipMasks:
    return FlipMasks(
        np.zeros(n, np.uint32), np.zeros(n, np.uint32), np.zeros(n, check_dtypes(n_check)[0])
    )


class FaultField:
    """Failure-threshold field over ``n_words`` codewords of 64 data bits and
    ``n_check`` check bits (default 8, SECDED).

    Deterministic in (platform, seed): repeated calls, any voltage order and
    any chunking of the work give identical masks. The draw has 64 + n_check
    bitplanes; without a burst its first 64 rows do not depend on
    ``n_check``, so the data masks are the same under every code. Under a
    ``burst`` they do: a plane shift carries bit 63 into the check bits and
    truncates at the top check plane, and the burst draws follow the
    (64 + n_check) x m base uniforms. A word-adjacent spill stops at a chunk
    edge (``chunk_words`` is part of the stream's layout). The last
    voltage's masks are kept, so a rail that did not move costs no draw.
    """

    def __init__(
        self,
        platform: PlatformProfile,
        n_words: int,
        seed: int = 0,
        chunk_words: int = 1 << 18,
        n_check: int = N_CHECK_DEFAULT,
        burst: BurstProfile | None = None,
    ):
        self.platform = platform
        self.n_words = int(n_words)
        self.seed = int(seed)
        self.chunk_words = int(chunk_words)
        self.n_check = int(n_check)
        self.burst = active_burst(burst)
        self._last: tuple | None = None  # (voltage, FlipMasks)

    def _chunk_rng(self, chunk_idx: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=(self.seed ^ (0xECC << 32), chunk_idx))
        )

    def chunk_masks(self, chunk_idx: int, m: int, rate: float):
        """(lo, hi, parity) of one ``m``-word chunk at per-bit ``rate``."""
        rng = self._chunk_rng(chunk_idx)
        sigma = self.platform.row_sigma
        z = rng.standard_normal(m, dtype=np.float32)
        f_row = np.exp(sigma * z - 0.5 * sigma * sigma)
        # u is drawn after f_row from the same counter stream; both are
        # voltage-independent, so FIP holds.
        u = rng.random((N_DATA_BITS + self.n_check, m), dtype=np.float32)
        p_word = np.clip(rate * f_row, 0.0, P_MAX)[None, :]
        bits = u < p_word
        if self.burst is not None:
            # the burst draws follow u from the same generator, each only if
            # its probability is nonzero, in the reference's order
            nb = N_DATA_BITS + self.n_check
            cu = rng.random((nb, m), dtype=np.float32) if self.burst.needs_class_draw else None
            wu = rng.random((nb, m), dtype=np.float32) if self.burst.word_adjacent > 0.0 else None
            eb = rng.integers(0, nb, m) if self.burst.random_double > 0.0 else None
            bits = expand_bursts(bits, self.burst, cu, wu, eb, xp=np)
        pdt = check_dtypes(self.n_check)[0]
        lo = np.zeros(m, np.uint32)
        hi = np.zeros(m, np.uint32)
        par = np.zeros(m, pdt)
        for b in range(32):
            lo |= bits[b].astype(np.uint32) << np.uint32(b)
        for b in range(32):
            hi |= bits[32 + b].astype(np.uint32) << np.uint32(b)
        for b in range(self.n_check):
            par |= bits[64 + b].astype(pdt) << pdt(b)
        return lo, hi, par

    def chunks(self):
        """(chunk index, first word, word count) of every chunk."""
        for ci, start in enumerate(range(0, self.n_words, self.chunk_words)):
            yield ci, start, min(self.chunk_words, self.n_words - start)

    def masks(self, v: float) -> FlipMasks:
        """XOR flip masks for the whole memory at rail voltage ``v``."""
        return gather_masks([(self, v)], workers=1)[0]

    def device_field(self, device=None) -> "DeviceFaultField":
        """The device field over the same geometry, seed and burst (its own
        stream); ``device`` None is the card."""
        return DeviceFaultField(self.platform, self.n_words, seed=self.seed,
                                n_check=self.n_check, burst=self.burst, device=device)

    def sweep_histogram(self, voltages) -> list[dict]:
        """Per-voltage fault statistics (paper Fig. 1 / Fig. 2b)."""
        out = []
        for v in voltages:
            counts = self.masks(v).flip_counts()
            out.append({
                "voltage": float(v),
                "faulty_bits": int(counts.sum()),
                "faults_per_mbit": counts.sum() / (self.n_words * 72 / (1024 * 1024)),
                "words_1bit": int((counts == 1).sum()),
                "words_2bit": int((counts == 2).sum()),
                "words_multi": int((counts >= 3).sum()),
            })
        return out


def gather_masks(requests, workers: int | None = None) -> list:
    """Masks of several fields, ``requests`` = [(field, voltage), ...].

    Chunks of every field whose voltage moved are drawn on a pool of
    ``workers`` threads (default: one per CPU); unmoved fields return their
    kept masks, zero-rate fields zero masks without drawing.
    """
    out: list = [None] * len(requests)
    tasks, drawn = [], []
    for i, (field, v) in enumerate(requests):
        v = float(v)
        if field._last is not None and field._last[0] == v:
            out[i] = field._last[1]
            continue
        out[i] = _zero_masks(field.n_words, field.n_check)
        drawn.append((field, v, out[i]))
        rate = field.platform.fault_rate(v)
        if rate > 0.0:
            tasks += [(field, out[i], c, rate) for c in field.chunks()]

    def draw(task):
        field, mk, (ci, start, m), rate = task
        lo, hi, par = field.chunk_masks(ci, m, rate)
        mk.lo[start : start + m] = lo
        mk.hi[start : start + m] = hi
        mk.parity[start : start + m] = par

    workers = workers or os.cpu_count() or 1
    if workers == 1 or len(tasks) <= 1:
        for t in tasks:
            draw(t)
    else:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            for _ in pool.map(draw, tasks):
                pass
    for field, v, mk in drawn:
        field._last = (v, mk)
    return out


def philox_key(seed_key: int) -> int:
    """The 64-bit Philox key of the bit stream whose row weakness comes from
    a generator seeded with ``seed_key``."""
    return (int(seed_key) ^ PHILOX_KEY_SALT) & (2**64 - 1)


def row_factor(n_words: int, row_sigma: float, seed_key: int, device) -> torch.Tensor:
    """(n_words,) float32 lognormal row weakness f = exp(sigma z - sigma^2 /
    2) (mean 1), z from ``torch.randn`` on a generator on ``device`` seeded
    with ``seed_key``."""
    gen = torch.Generator(device=device).manual_seed(int(seed_key))
    z = torch.randn(n_words, generator=gen, device=device, dtype=torch.float32)
    return torch.exp(row_sigma * z - 0.5 * row_sigma * row_sigma)


class DeviceFaultField:
    """Failure-threshold field drawn on the device by the fault-field kernel.

    In place of a FaultField in the batched voltage step: ``masks(v)``
    returns (lo int32, hi int32, check) tensors on the field's device and
    never touches host memory. The row weakness is drawn once, when the field
    is made (seeded from ``seed ^ 0xECC``), and kept; the random bits depend
    only on (seed, word), so voltage enters through each word's threshold
    alone and FIP holds per word. ``chunk_words`` (None: the plain
    version's own ``FIELD_CPU_CHUNK``) is the words the plain version draws
    at a time on the CPU; the card draws the field in one launch, and the
    masks do not depend on it. ``burst`` expands the anchors in the same
    launch; a word-adjacent spill stops only at the field's ends (the
    reference's device field stops at its 2^18-word chunk edges).
    ``device`` None is the card.
    """

    def __init__(
        self,
        platform: PlatformProfile,
        n_words: int,
        seed: int = 0,
        chunk_words: int | None = None,
        n_check: int = N_CHECK_DEFAULT,
        burst: BurstProfile | None = None,
        device=None,
    ):
        self.platform = platform
        self.n_words = int(n_words)
        self.seed = int(seed)
        self.chunk_words = kops.FIELD_CPU_CHUNK if chunk_words is None else int(chunk_words)
        self.n_check = int(n_check)
        self.burst = active_burst(burst)
        self.device = resolve_device(device)
        self.key = philox_key(self.seed ^ 0xECC)
        self.f_row = row_factor(self.n_words, float(platform.row_sigma), self.seed ^ 0xECC,
                                self.device)

    def masks(self, v: float):
        """(lo, hi, check) flip masks at rail voltage ``v``."""
        return self.masks_for_rates(self.platform.fault_rate(float(v)))

    def masks_for_rates(self, rates):
        """Masks for a scalar rate or an (n_words,) per-word rate vector
        (tensor or array), rounded to float32.

        Per-word rates are how multi-rail domains share one stream: a word's
        rail enters through its threshold alone, so a uniform rate vector
        gives the scalar path's masks bit for bit. A zero scalar rate gives
        zero masks made on the device, without a launch."""
        if not isinstance(rates, (torch.Tensor, np.ndarray)) or np.ndim(rates) == 0:
            rate = float(np.float32(rates))
            if rate == 0.0:
                return zero_masks(self.n_words, self.n_check, self.device)
        else:
            rate = torch.as_tensor(rates).to(self.device, torch.float32)
            if rate.shape != (self.n_words,):
                raise ValueError(f"expected ({self.n_words},) rates, got {tuple(rate.shape)}")
        return kops.fault_field(self.f_row, rate, self.key, self.n_check, burst=self.burst,
                                chunk_words=self.chunk_words)


def zero_masks(n_words: int, n_check: int, device):
    """All-zero (lo int32, hi int32, check) masks made on ``device``."""
    return tuple(torch.zeros(n_words, dtype=dt, device=device)
                 for dt in (torch.int32, torch.int32, check_dtypes(n_check)[1]))


def interval_key(seed: int, interval: int) -> int:
    """The 63-bit key of KV fault interval ``interval`` of the stream seeded
    ``seed``: bits 0-31 the interval, bits 32-62 the low 31 bits of ``seed ^
    0xCACE`` XOR the seed's bits above 32 times an odd constant (mod 2^31).
    A seed below 2^32 gives ``((seed ^ 0xCACE) << 32 | interval)`` cut to
    63 bits. A shard's seed (``collectives.shard_seed``: the shard in the
    bits above 32) XORs its keys with the shard's odd multiple, which
    differs for every shard below 2^31, so for one seed no two (shard,
    interval) pairs share a key while the interval stays below 2^32."""
    high = int(seed) ^ 0xCACE
    high = (high & 0x7FFFFFFF) ^ (((high >> 32) * 0x9E3779B1) & 0x7FFFFFFF)
    return (high << 32) | (int(interval) & 0xFFFFFFFF)


def interval_masks(seed: int, interval: int, n_words: int, rate: float, row_sigma: float,
                   n_check: int = N_CHECK_DEFAULT, device=None, burst=None):
    """One fault interval's (lo int32, hi int32, check) flip masks for
    ``n_words`` words (check uint8, or int32 beyond 8 check bits) on
    ``device``: a fault field keyed by (seed ^ 0xCACE, interval), its row
    weakness drawn anew for the interval by one ``torch.randn``, its bits
    (and the expansion of ``burst``, a BurstProfile) by one launch of the
    fault-field kernel (the plain version off the card). ``device`` None is
    the card."""
    dev = resolve_device(device)
    key = interval_key(seed, interval)
    f_row = row_factor(n_words, float(row_sigma), key, dev)
    return kops.fault_field(f_row, float(np.float32(rate)), philox_key(key), n_check,
                            burst=burst)
