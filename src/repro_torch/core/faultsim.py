"""Deterministic per-bitcell failure-threshold field (undervolting fault model).

Every bitcell *i* has a latent uniform draw ``u_i`` (numpy Philox keyed by
(seed, word-chunk)) and every word a lognormal weakness ``f_w`` (E[f] = 1).
At rail voltage V the cell is faulty iff ``u_i < clip(rate(V) * f_w, 0,
P_MAX)``. ``rate`` falls with V and ``u_i`` is fixed, so the faulty set at a
lower voltage is a superset (the paper's Fault Inclusion Property).

The stream is the host numpy stream of the reference fault model, bit for
bit. Two shortcuts keep it identical: at ``fault_rate(v) == 0`` (at or
above V_min) no draw is made and the masks are zero, since ``u < 0`` is
never true; and ``gather_masks`` draws the chunks of many fields on a
thread pool (numpy's generators and elementwise ops release the GIL), each
chunk from its own counter-keyed generator, so the order of work does not
matter.

``interval_masks`` is the paged KV cache's per-interval draw on the arena's
device: the same model (lognormal row weakness, per-bit Bernoulli) from a
``torch.Generator``. The reference draws it with JAX's threefry, which no
torch generator reproduces, so that stream is equal to the reference's in
distribution only; parity tests hand both packages the same numpy masks.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os

import numpy as np
import torch

from repro_torch.codes.base import narrow, popcount32, widen
from repro_torch.core.voltage import PlatformProfile
from repro_torch.kernels.backend import resolve_device, to_device

P_MAX = 0.5  # per-bit fault probability ceiling
N_DATA_BITS = 64
N_CHECK_DEFAULT = 8  # SECDED(72,64)
KV_CHUNK_WORDS = 1 << 18  # words per draw of interval_masks


@dataclasses.dataclass(frozen=True)
class FlipMasks:
    """Read-time XOR masks for a (n_words,) memory at one voltage."""

    lo: np.ndarray  # (n,) uint32 — flips in data bits 0..31
    hi: np.ndarray  # (n,) uint32 — flips in data bits 32..63
    parity: np.ndarray  # (n,) uint8 — flips in the check bits

    def flip_counts(self) -> np.ndarray:
        """Ground-truth number of flipped bits per codeword."""
        cnt = _popcount32(self.lo) + _popcount32(self.hi)
        return (cnt + _popcount32(self.parity.astype(np.uint32))).astype(np.int32)


def flip_counts(mlo: torch.Tensor, mhi: torch.Tensor, mcheck: torch.Tensor) -> torch.Tensor:
    """Ground-truth flipped bits per codeword of mask tensors (int32 lo/hi
    bit patterns, uint8 check), on their device (int64)."""
    return popcount32(widen(mlo)) + popcount32(widen(mhi)) + popcount32(mcheck.to(torch.int64))


def device_masks(field: "FaultField", v: float, device, shape=None):
    """The field's (lo int32, hi int32, check uint8) masks at rail voltage
    ``v`` as tensors on ``device``, shaped ``shape`` (default flat). At a
    zero fault rate they are zeros made on the device: no draw, no copy. A
    drawn field's kept masks are reused, so a caller can draw many fields at
    once with ``gather_masks`` first."""
    shape = (field.n_words,) if shape is None else tuple(shape)
    if field.platform.fault_rate(float(v)) == 0.0:
        return tuple(
            torch.zeros(shape, dtype=dt, device=device)
            for dt in (torch.int32, torch.int32, torch.uint8)
        )
    m = field.masks(v)
    return tuple(
        to_device(a.reshape(shape), device)
        for a in (m.lo.view(np.int32), m.hi.view(np.int32), m.parity)
    )


def _popcount32(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32).copy()
    v = v - ((v >> 1) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
    v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> 24).astype(np.int64)


def _zero_masks(n: int) -> FlipMasks:
    return FlipMasks(
        np.zeros(n, np.uint32), np.zeros(n, np.uint32), np.zeros(n, np.uint8)
    )


class FaultField:
    """Failure-threshold field over ``n_words`` 72-bit codewords.

    Deterministic in (platform, seed): repeated calls, any voltage order and
    any chunking of the work give identical masks. The last voltage's masks
    are kept, so a rail that did not move costs no draw.
    """

    def __init__(
        self,
        platform: PlatformProfile,
        n_words: int,
        seed: int = 0,
        chunk_words: int = 1 << 18,
    ):
        self.platform = platform
        self.n_words = int(n_words)
        self.seed = int(seed)
        self.chunk_words = int(chunk_words)
        self.n_check = N_CHECK_DEFAULT
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
        lo = np.zeros(m, np.uint32)
        hi = np.zeros(m, np.uint32)
        par = np.zeros(m, np.uint8)
        for b in range(32):
            lo |= bits[b].astype(np.uint32) << np.uint32(b)
        for b in range(32):
            hi |= bits[32 + b].astype(np.uint32) << np.uint32(b)
        for b in range(self.n_check):
            par |= bits[64 + b].astype(np.uint8) << np.uint8(b)
        return lo, hi, par

    def chunks(self):
        """(chunk index, first word, word count) of every chunk."""
        for ci, start in enumerate(range(0, self.n_words, self.chunk_words)):
            yield ci, start, min(self.chunk_words, self.n_words - start)

    def masks(self, v: float) -> FlipMasks:
        """XOR flip masks for the whole memory at rail voltage ``v``."""
        return gather_masks([(self, v)], workers=1)[0]


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
        out[i] = _zero_masks(field.n_words)
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


def interval_masks(seed: int, interval: int, n_words: int, rate: float, row_sigma: float,
                   n_check: int = N_CHECK_DEFAULT, device=None):
    """One fault interval's (lo int32, hi int32, check uint8) flip masks for
    ``n_words`` words, drawn on ``device`` by a ``torch.Generator`` seeded
    from (seed ^ 0xCACE, interval), in chunks of ``KV_CHUNK_WORDS``.

    Per chunk: a lognormal row factor f = exp(sigma z - sigma^2 / 2) (mean
    1), the word's per-bit probability p = clip(rate f, 0, P_MAX) in
    float32, and bit b of the word flips iff its uniform 32-bit draw is below
    floor(p 2^32), for 64 + n_check bitplanes. ``device`` None is the card."""
    dev = resolve_device(device)
    key = (((int(seed) ^ 0xCACE) << 32) | (int(interval) & 0xFFFFFFFF)) & ((1 << 63) - 1)
    gen = torch.Generator(device=dev).manual_seed(key)
    nb = N_DATA_BITS + n_check
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=dev), torch.arange(32, device=dev)
    )[:, None]
    los, his, pars = [], [], []
    for start in range(0, n_words, KV_CHUNK_WORDS):
        m = min(KV_CHUNK_WORDS, n_words - start)
        z = torch.randn(m, generator=gen, device=dev, dtype=torch.float32)
        f_row = torch.exp(row_sigma * z - 0.5 * row_sigma * row_sigma)
        p_word = torch.clamp(float(rate) * f_row, 0.0, P_MAX)
        thresh = (p_word * 4294967296.0).to(torch.int64)
        bits = torch.randint(0, 1 << 32, (nb, m), generator=gen, device=dev, dtype=torch.int64)
        faulty = (bits < thresh[None, :]).to(torch.int64)
        los.append(narrow((faulty[:32] * weights).sum(dim=0)))
        his.append(narrow((faulty[32:64] * weights).sum(dim=0)))
        pars.append((faulty[64:] * weights[:n_check]).sum(dim=0).to(torch.uint8))
    if not los:
        z32 = torch.zeros(0, dtype=torch.int32, device=dev)
        return z32, z32.clone(), torch.zeros(0, dtype=torch.uint8, device=dev)
    return torch.cat(los), torch.cat(his), torch.cat(pars)
