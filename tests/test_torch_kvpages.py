"""Port parity for the paged KV cache's bookkeeping and arena: the page
table dedup, the allocator and the prefix trie under the same operation
sequences, and the arena's planes and counters through commit -> tick ->
scrub -> zero_pages with the same fault masks handed to both packages; plus
the port's own device fault draw against the fault model."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import tiny_cfg
from repro.core import kvpages as jkv
from repro_torch.core import faultsim as tfs
from repro_torch.core import kvpages as tkv
from repro_torch.core import voltage as tv
from repro_torch.models import base as tbase


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", [(1, 1), (3, 4), (4, 8)])
def test_dedup_page_table_equal(seed, shape):
    rng = np.random.default_rng(seed)
    scratch = 20
    table = rng.integers(0, 6, shape).astype(np.int32)
    table[rng.random(shape) < 0.3] = scratch
    j = jkv.dedup_page_table(table, scratch)
    t = tkv.dedup_page_table(table, scratch)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _alloc_trace(mod, seed):
    """A random sequence of alloc/share/free/recycle; returns every result
    and the allocator's state after each operation."""
    rng = np.random.default_rng(seed)
    alloc = mod.PageAllocator(10)
    held: dict = {}
    out = []
    for _ in range(120):
        op = rng.integers(0, 4)
        owner = int(rng.integers(0, 4))
        if op == 0:
            page = alloc.alloc(owner)
            if page is not None:
                held.setdefault(owner, []).append(page)
            out.append(("alloc", page))
        elif op == 1 and held:
            src = sorted(held)[int(rng.integers(0, len(held)))]
            page = held[src][0]
            if owner not in (alloc.owner_of(page) if alloc.is_shared(page) else {src}):
                alloc.share(page, owner)
                held.setdefault(owner, []).append(page)
                out.append(("share", page, owner))
        elif op == 2 and held.get(owner):
            pages = held.pop(owner)
            alloc.free(pages, owner)
            out.append(("free", tuple(pages)))
        else:
            out.append(("recycle", tuple(alloc.recycle())))
        out.append((alloc.free_pages, alloc.dirty_pages, alloc.used_pages,
                    tuple(alloc.shared_pages())))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_page_allocator_equal_under_same_operations(seed):
    assert _alloc_trace(tkv, seed) == _alloc_trace(jkv, seed)


def _trie_trace(mod, seed):
    rng = np.random.default_rng(seed)
    alloc = mod.PageAllocator(24)
    trie = mod.PrefixTrie(alloc, 4)
    base = rng.integers(0, 5, 16)
    out = []
    for rid in range(10):
        n_common = int(rng.integers(0, 16))
        seq = np.concatenate([base[:n_common], rng.integers(0, 5, int(rng.integers(1, 9)))])
        shared = trie.lookup(seq)
        out.append(("lookup", tuple(shared)))
        for p in shared:
            alloc.share(p, rid)
        need = -(-len(seq) // 4) - len(shared)
        fresh = []
        for _ in range(need):
            page = alloc.alloc(rid)
            if page is None:
                out.append(("evict", tuple(trie.evict_lru(1))))
                alloc.recycle()
                page = alloc.alloc(rid)
            fresh.append(page)
        pages = shared + fresh
        trie.insert(seq, pages[: len(seq) // 4])
        if rng.random() < 0.5:
            alloc.free([p for p in pages if p is not None], rid)
        out.append((tuple(pages), tuple(trie.pages()), len(trie), alloc.free_pages))
    out.append(("drain", tuple(sorted(trie.drain())), alloc.free_pages))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_prefix_trie_equal_under_same_operations(seed):
    assert _trie_trace(tkv, seed) == _trie_trace(jkv, seed)


# -- the arena under shared masks ----------------------------------------------


class SharedMasks:
    """Per-interval flip masks from numpy, handed to both packages: the
    n-th draw of either arena gets the same masks (the reference's threefry
    stream cannot be reproduced by a torch generator)."""

    def __init__(self, seed):
        self.seed = seed
        self.calls = 0

    def draw(self, n_words, rate, n_check):
        self.calls += 1
        rng = np.random.default_rng((self.seed, self.calls))
        p = np.float32(rate) * 40  # dense enough for multi-bit words
        bits = rng.random((64 + n_check, n_words), dtype=np.float32) < p
        w = (1 << np.arange(32, dtype=np.uint64))[:, None]
        lo = (bits[:32] * w).sum(0).astype(np.uint32)
        hi = (bits[32:64] * w).sum(0).astype(np.uint32)
        chk = (bits[64:] * w[:n_check]).sum(0).astype(np.uint8 if n_check <= 8 else np.uint32)
        return lo, hi, chk

    def reference(self):
        def fn(key, m, rate, sigma, n_check=8, burst=None):
            return tuple(jnp.asarray(a) for a in self.draw(m, float(rate), n_check))

        return lambda: fn

    def port(self):
        return lambda interval, m, rate, sigma, n_check: self.draw(m, rate, n_check)


def _geoms():
    jcfg = tiny_cfg()
    tcfg = tbase.ModelConfig(
        name="tiny", family="dense", n_layers=jcfg.n_layers, d_model=jcfg.d_model,
        n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads, d_ff=jcfg.d_ff, vocab=jcfg.vocab,
        head_dim=jcfg.head_dim,
    )
    return jkv.KVGeometry.from_config(jcfg, 4), tkv.KVGeometry.from_config(tcfg, 4)


def _planes_equal(ja, ta):
    np.testing.assert_array_equal(ta.lo.numpy().view(np.uint32), np.asarray(ja.lo))
    np.testing.assert_array_equal(ta.hi.numpy().view(np.uint32), np.asarray(ja.hi))
    jp = np.asarray(ja.parity)
    np.testing.assert_array_equal(ta.parity.numpy().view(jp.dtype), jp)


@pytest.mark.parametrize("ecc", [True, False])
def test_arena_sequence_bit_identical_under_shared_masks(monkeypatch, ecc):
    jgeom, tgeom = _geoms()
    assert dataclasses.astuple(jgeom) == dataclasses.astuple(tgeom)
    from repro.core import voltage as jv

    jm, tm = SharedMasks(7), SharedMasks(7)
    monkeypatch.setattr(jkv, "_device_chunk_masks_jit", jm.reference())
    n_pages = 6
    ja = jkv.KVPageArena(jgeom, jv.PLATFORMS["vc707"], n_pages, seed=2, ecc=ecc)
    ta = tkv.KVPageArena(tgeom, tv.PLATFORMS["vc707"], n_pages, seed=2, ecc=ecc, device="cpu",
                         mask_fn=tm.port())
    rng = np.random.default_rng(0)
    for step, v in enumerate((1.0, 0.56, 0.55, 0.54)):
        payload = rng.standard_normal((5, tgeom.token_f32)).astype(np.float32)
        pages = rng.choice(n_pages, 5).astype(np.int32)
        slots = rng.permutation(4)[np.arange(5) % 4].astype(np.int32)
        keep = np.unique(pages * 4 + slots, return_index=True)[1]  # distinct cells
        ja.commit_tokens(jnp.asarray(payload[keep]), pages[keep], slots[keep])
        ta.commit_tokens(torch.from_numpy(payload[keep]), pages[keep], slots[keep])
        _planes_equal(ja, ta)
        for a in (ja, ta):
            a.set_voltage(v)
            a.tick()
        assert ja.faulted == ta.faulted
        _planes_equal(ja, ta)
        ids = np.array([pages[0], n_pages, pages[1], pages[0], 3], np.int32)
        jp, jc = ja.scrub_pages(ids)
        tp, tc = ta.scrub_pages(ids)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tp.numpy().view(np.uint32), np.asarray(jp).view(np.uint32))
        _planes_equal(ja, ta)
        if step >= 2 and ecc:
            assert tc[:, 1].sum() > 0  # faults were corrected
        if not ecc:
            assert tc[:, 1:3].sum() == 0  # re-encoded check bits see nothing
        zero = rng.choice(n_pages, 2, replace=False)
        ja.zero_pages(zero)
        ta.zero_pages(zero)
        _planes_equal(ja, ta)
    assert jm.calls == tm.calls == 3  # no draw inside the guardband


CODECS = ("parity65", "secded72", "ileave88", "dected79")


@pytest.mark.parametrize("codec", CODECS)
def test_arena_round_trip_at_nominal_under_every_codec(codec):
    """Commit, tick (no draw inside the guardband) and scrub give back the
    committed payload; the check plane has the codec's dtype and every
    scrubbed word is clean."""
    _, tgeom = _geoms()
    ta = tkv.KVPageArena(tgeom, tv.PLATFORMS["vc707"], 5, codec=codec, device="cpu",
                         mask_fn=lambda *a: pytest.fail("drew at nominal"))
    assert ta.parity.dtype == ta.codec.check_torch_dtype
    rng = np.random.default_rng(3)
    payload = rng.standard_normal((8, tgeom.token_f32)).astype(np.float32)
    pages, slots = np.repeat([0, 2, 4], [4, 3, 1]), np.array([0, 1, 2, 3, 0, 2, 3, 1])
    ta.commit_tokens(torch.from_numpy(payload), pages, slots)
    ta.tick()
    out, cnt = ta.scrub_pages([0, 2, 4])
    for row, (p, s_) in enumerate(zip(pages, slots)):
        np.testing.assert_array_equal(out[[0, 2, 4].index(p), s_].numpy(), payload[row])
    assert cnt[:, 0].sum() == 3 * tgeom.words_per_page and cnt[:, 1:3].sum() == 0


@pytest.mark.parametrize("codec", CODECS)
def test_arena_commit_and_scrub_bit_identical_per_codec(monkeypatch, codec):
    """Commit -> tick -> scrub under each codec with the same masks handed to
    both packages: planes in the codec's check dtype, payloads and per-page
    counters bit for bit (a stronger code corrects what SECDED detects)."""
    jgeom, tgeom = _geoms()
    from repro.core import voltage as jv

    jm, tm = SharedMasks(11), SharedMasks(11)
    monkeypatch.setattr(jkv, "_device_chunk_masks_jit", jm.reference())
    n_pages = 6
    ja = jkv.KVPageArena(jgeom, jv.PLATFORMS["vc707"], n_pages, seed=1, codec=codec)
    ta = tkv.KVPageArena(tgeom, tv.PLATFORMS["vc707"], n_pages, seed=1, codec=codec,
                         device="cpu", mask_fn=tm.port())
    rng = np.random.default_rng(2)
    seen = np.zeros(3, np.int64)
    for v in (0.56, 0.54):
        payload = rng.standard_normal((4, tgeom.token_f32)).astype(np.float32)
        pages, slots = np.array([0, 1, 3, 5]), np.array([0, 2, 1, 3])
        ja.commit_tokens(jnp.asarray(payload), pages, slots)
        ta.commit_tokens(torch.from_numpy(payload), pages, slots)
        _planes_equal(ja, ta)
        for a in (ja, ta):
            a.set_voltage(v)
            a.tick()
        _planes_equal(ja, ta)
        ids = np.array([0, n_pages, 1, 0, 5, 3], np.int32)
        jp, jc = ja.scrub_pages(ids)
        tp, tc = ta.scrub_pages(ids)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tp.numpy().view(np.uint32), np.asarray(jp).view(np.uint32))
        _planes_equal(ja, ta)
        seen += tc[:, :3].sum(0)
    assert seen[2] > 0 and (seen[1] > 0) == (codec != "parity65")
    assert jm.calls == tm.calls == 2


def test_arena_from_numpy_carries_reference_planes():
    jgeom, tgeom = _geoms()
    from repro.core import voltage as jv

    ja = jkv.KVPageArena(jgeom, jv.PLATFORMS["vc707"], 3)
    rng = np.random.default_rng(1)
    ja.commit_tokens(
        jnp.asarray(rng.standard_normal((2, jgeom.token_f32)), jnp.float32),
        np.array([0, 2], np.int32), np.array([1, 3], np.int32),
    )
    ta = tkv.KVPageArena(tgeom, tv.PLATFORMS["vc707"], 3, device="cpu")
    tkv.arena_from_numpy(ta, np.asarray(ja.lo), np.asarray(ja.hi), np.asarray(ja.parity))
    _planes_equal(ja, ta)
    _, jc = ja.scrub_pages([0, 2])
    _, tc = ta.scrub_pages([0, 2])
    np.testing.assert_array_equal(tc, jc)


# -- the port's own fault draw ---------------------------------------------------


def _flips(lo, hi, chk):
    pc = tfs._popcount32
    u = lambda t: t.numpy().view(np.uint32)
    return pc(u(lo)) + pc(u(hi)) + pc(chk.numpy().astype(np.uint32))


@pytest.mark.parametrize("voltage", [0.56, 0.55, 0.54])
def test_interval_masks_statistics_vs_host_model(voltage):
    """The device draw against the host FaultField (the model's numpy
    oracle) over 2^18 words. Different streams of one model: total flips
    within sampling noise, where the lognormal row factor (sigma = the
    platform's row_sigma) inflates the variance over Poisson by about
    e^{sigma^2}; the multi-bit share of faulty words within 0.1."""
    plat = tv.PLATFORMS["vc707"]
    n = 1 << 18
    hm = tfs.FaultField(plat, n, seed=11).masks(voltage)
    rate = plat.fault_rate(voltage)
    d = _flips(*tfs.interval_masks(11, 1, n, rate, plat.row_sigma, device="cpu"))
    h = hm.flip_counts()
    assert h.sum() > 100
    assert 0.6 < d.sum() / h.sum() < 1.6, (voltage, int(h.sum()), int(d.sum()))
    h_frac = (h >= 2).sum() / max((h >= 1).sum(), 1)
    d_frac = (d >= 2).sum() / max((d >= 1).sum(), 1)
    assert abs(h_frac - d_frac) < 0.1, (voltage, h_frac, d_frac)


def test_interval_masks_deterministic_and_per_interval():
    a = tfs.interval_masks(3, 1, 5000, 1e-3, 0.5, device="cpu")
    b = tfs.interval_masks(3, 1, 5000, 1e-3, 0.5, device="cpu")
    c = tfs.interval_masks(3, 2, 5000, 1e-3, 0.5, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].dtype == torch.int32 and a[2].dtype == torch.uint8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfs.interval_masks(3, 1, 5000, 1e-3, 0.5)


def test_supports_paged_kv():
    from repro.configs import get_smoke_config as jsmoke
    from repro.configs.shapes import supports_paged_kv as jsupports
    from repro_torch.configs import get_config, get_smoke_config, shapes

    assert shapes.supports_paged_kv(get_config("qwen3-0.6b"))
    assert shapes.supports_paged_kv(get_smoke_config("qwen3-0.6b"))
    assert jsupports(jsmoke("qwen3-0.6b"))
