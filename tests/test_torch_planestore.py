"""Port parity: the plane arena over a voltage walk and the DED-canary
controllers against the reference, bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import shapes as jshapes
from repro.core import controller as jctl
from repro.core import planestore as jps
from repro.core import telemetry as jtel
from repro.core import voltage as jv
from repro.kernels import ops as jops
from repro_torch.configs import shapes as tshapes
from repro_torch.core import controller as tctl
from repro_torch.core import faultsim as tfs
from repro_torch.core import planestore as tps
from repro_torch.core import telemetry as ttel
from repro_torch.core import voltage as tv
from repro_torch.kernels import ops as tops

KEYS = (
    "['blocks']['p0']['attn']['wq']",
    "['blocks']['p0']['mlp']['w1']",
    "['embed']",
)
WALK = (1.0, 0.6, 0.58, 0.56, 0.55, 0.54, 0.57)


def _stats(s) -> dict:
    return dataclasses.asdict(s)


def _record(r) -> dict:
    """A controller record by the port's fields (the reference's records
    also carry mesh-shard and accuracy-canary fields the port has not yet)."""
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(tctl.ControllerRecord)}


@pytest.fixture(scope="module")
def leaves():
    rng = np.random.default_rng(0)
    ws = [rng.standard_normal(s).astype(np.float32) for s in ((64, 96), (128, 64), (256, 64))]
    return (
        [jops.pack_ecc_weights(jnp.asarray(w)) for w in ws],
        [tops.pack_ecc_weights(torch.from_numpy(w)) for w in ws],
    )


def _assert_leaves_equal(jl, tl):
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.lo.numpy().view(np.uint32), np.asarray(a.lo))
        np.testing.assert_array_equal(b.hi.numpy().view(np.uint32), np.asarray(a.hi))
        np.testing.assert_array_equal(b.parity.numpy(), np.asarray(a.parity))
        np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))


def test_leaf_seed_identical():
    for key in KEYS:
        for seed in (0, 1, 12345):
            assert tps.leaf_seed(seed, key) == jps.leaf_seed(seed, key)


def test_domains_identical():
    assert tshapes.MEMORY_DOMAINS == jshapes.MEMORY_DOMAINS
    for key in KEYS + ("['blocks']['p0']['attn']['wk']", "['lm_head']", "['x']"):
        assert tshapes.domain_of(key) == jshapes.domain_of(key)
    assert tshapes.domain_codecs() == jshapes.domain_codecs()


@pytest.mark.parametrize("ecc", [True, False])
def test_single_rail_voltage_walk_bit_identical(leaves, ecc):
    jl, tl = leaves
    jstore = jps.PlaneStore(jl, KEYS, jv.PLATFORMS["vc707"], seed=3)
    tstore = tps.PlaneStore(tl, KEYS, tv.PLATFORMS["vc707"], seed=3)
    assert tstore.n_words == jstore.n_words and tstore.domains == jstore.domains
    for v in WALK:
        jf, js = jstore.set_voltage(v, ecc=ecc)
        tf, ts = tstore.set_voltage(v, ecc=ecc)
        assert _stats(ts) == _stats(js), v
        _assert_leaves_equal(jf, tf)


@pytest.mark.parametrize("volts", [1.0, 0.61, {"attention": 1.0, "mlp": 0.65, "embedding": 0.61}])
def test_zero_rate_masks_are_made_on_the_device_without_drawing(leaves, volts):
    _, tl = leaves
    store = tps.PlaneStore(tl, KEYS, tv.PLATFORMS["vc707"], seed=3, domain_key=tshapes.domain_of)
    masks = store.host_masks(volts)
    assert [m.dtype for m in masks] == [torch.int32, torch.int32, torch.uint8]
    assert all(m.shape == (store.n_words,) and not m.any() for m in masks)
    assert all(f._last is None for f in store._host_fields.values())  # nothing drawn
    # the drawn path at the same voltages gives the same (zero) masks
    per_dom = volts if isinstance(volts, dict) else dict.fromkeys(store.domains, volts)
    drawn = tfs.gather_masks(
        [(store._host_fields[s.key], per_dom[s.domain]) for s in store.slots]
    )
    assert all(not (m.lo.any() or m.hi.any() or m.parity.any()) for m in drawn)


def test_multi_rail_walk_bit_identical(leaves):
    jl, tl = leaves
    prof_j = jv.derive_domain_profiles(jv.PLATFORMS["kc705a"], jshapes.MEMORY_DOMAINS, 0.5, 1)
    prof_t = tv.derive_domain_profiles(tv.PLATFORMS["kc705a"], tshapes.MEMORY_DOMAINS, 0.5, 1)
    jstore = jps.PlaneStore(jl, KEYS, jv.PLATFORMS["kc705a"], seed=1,
                            domain_key=jshapes.domain_of, profiles=prof_j)
    tstore = tps.PlaneStore(tl, KEYS, tv.PLATFORMS["kc705a"], seed=1,
                            domain_key=tshapes.domain_of, profiles=prof_t)
    assert tstore.domains == jstore.domains == ("attention", "mlp", "embedding")
    assert tstore.words_by_domain() == jstore.words_by_domain()
    assert tstore.check_bits_by_domain() == jstore.check_bits_by_domain()
    for a, b, c in ((1.0, 1.0, 1.0), (0.56, 0.58, 0.54), (0.54, 0.6, 0.55), (0.56, 0.58, 0.54)):
        volts = {"attention": a, "mlp": b, "embedding": c}
        jf, js = jstore.set_rails(volts)
        tf, ts = tstore.set_rails(volts)
        assert ts.domains == js.domains
        for d in js.domains:
            assert _stats(ts[d]) == _stats(js[d]), (volts, d)
        _assert_leaves_equal(jf, tf)
    # a uniform schedule is the single-rail step
    rails = tps.PlaneStore(tl, KEYS, tv.PLATFORMS["kc705a"], seed=1, domain_key=tshapes.domain_of)
    single = tps.PlaneStore(tl, KEYS, tv.PLATFORMS["kc705a"], seed=1)
    rf, rs = rails.set_rails(dict.fromkeys(rails.domains, 0.55))
    sf, ss = single.set_voltage(0.55)
    assert rs.total().counters().tolist() == ss.counters().tolist()
    assert ss.faulty_words > 0
    for a, b in zip(rf, sf):
        assert torch.equal(a.lo, b.lo) and torch.equal(a.parity, b.parity)


def _counter_stream(rng, n):
    out = []
    for i in range(n):
        c = rng.integers(0, 4, 8)
        c[2] = 1 if i in (6, 9) else 0  # DED events
        c[3] = 1 if i == 4 else 0  # a silent event
        out.append(c)
    return out


@pytest.mark.parametrize("kw", [
    {}, {"paranoid": True}, {"start_v": 0.62}, {"step_v": 0.02, "adaptive": True},
    {"start_v": 0.58, "paranoid": True, "adaptive": True},
])
def test_controller_records_identical(kw):
    stream = _counter_stream(np.random.default_rng(0), 80)
    pj, pt = jv.PLATFORMS["vc707"], tv.PLATFORMS["vc707"]
    j, t = jctl.UndervoltController(pj, **kw), tctl.UndervoltController(pt, **kw)
    for c in stream:
        vj = j.update(jtel.FaultStats.from_counters(c, 100))
        vt = t.update(ttel.FaultStats.from_counters(c, 100))
        assert vj == vt
    assert [_record(r) for r in t.history] == [_record(r) for r in j.history]
    assert t.locked == j.locked


def test_multirail_controller_records_identical():
    rng = np.random.default_rng(1)
    domains = ("attention", "mlp", "embedding")
    pj = jv.derive_domain_profiles(jv.PLATFORMS["vc707"], domains, 0.5, 0)
    pt = tv.derive_domain_profiles(tv.PLATFORMS["vc707"], domains, 0.5, 0)
    j = jctl.MultiRailController(jv.PLATFORMS["vc707"], domains, start_v=0.62, profiles=pj)
    t = tctl.MultiRailController(tv.PLATFORMS["vc707"], domains, start_v=0.62, profiles=pt)
    for i in range(30):
        block = rng.integers(0, 3, (3, 8))
        block[:, 2] = [int(i == 5), int(i == 8), 0]
        words = dict.fromkeys(domains, 50)
        vj = j.update(jtel.FaultStats.from_counter_matrix(block, domains, words))
        vt = t.update(ttel.FaultStats.from_counter_matrix(block, domains, words))
        assert vj == vt
    assert {d: [_record(r) for r in h] for d, h in t.history.items()} == {
        d: [_record(r) for r in h] for d, h in j.history.items()
    }
    assert t.locked == j.locked and t.codecs == j.codecs


CODEC_KEYS = KEYS + ("['blocks']['p0']['attn']['wo']", "['blocks']['p0']['mlp']['w2']")
MIXED = {"attention": "parity65", "mlp": "dected79", "embedding": "ileave88"}


@pytest.fixture(scope="module")
def codec_leaves():
    rng = np.random.default_rng(5)
    ws = [rng.standard_normal(s).astype(np.float32)
          for s in ((64, 96), (128, 64), (256, 64), (96, 64), (64, 128))]
    return (
        [jops.pack_ecc_weights(jnp.asarray(w)) for w in ws],
        [tops.pack_ecc_weights(torch.from_numpy(w)) for w in ws],
    )


def _assert_codec_leaves_equal(jl, tl):
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.lo.numpy().view(np.uint32), np.asarray(a.lo))
        np.testing.assert_array_equal(b.hi.numpy().view(np.uint32), np.asarray(a.hi))
        pa = np.asarray(a.parity)
        np.testing.assert_array_equal(b.parity.numpy().view(pa.dtype), pa)


def _assert_groups_equal(jstore, tstore):
    assert [g.name for g in tstore.groups] == [g.name for g in jstore._groups]
    for jg, tg in zip(jstore._groups, tstore.groups):
        assert (tg.slot_ids, tg.offsets, tg.n_words) == (jg.slot_ids, jg.offsets, jg.n_words)
        assert tg.check.dtype == tg.codec.check_torch_dtype
        jc = np.asarray(jg.check)
        np.testing.assert_array_equal(tg.check.numpy().view(jc.dtype), jc)
        np.testing.assert_array_equal(tg.lo.numpy().view(np.uint32), np.asarray(jg.lo))
        np.testing.assert_array_equal(tg.dom_ids.numpy(), np.asarray(jg.dom_ids))
        for si in tg.slot_ids:
            key = tstore.slots[si].key
            assert tstore._host_fields[key].n_check == jstore._host_fields[key].n_check
    assert tstore.codecs_by_domain() == jstore.codecs_by_domain()
    assert tstore.check_bits_by_domain() == jstore.check_bits_by_domain()


def test_mixed_codec_partition_and_dtypes(codec_leaves):
    jl, tl = codec_leaves
    jstore = jps.PlaneStore(jl, CODEC_KEYS, jv.PLATFORMS["vc707"], seed=2,
                            domain_key=jshapes.domain_of, codecs=MIXED)
    tstore = tps.PlaneStore(tl, CODEC_KEYS, tv.PLATFORMS["vc707"], seed=2,
                            domain_key=tshapes.domain_of, codecs=MIXED)
    _assert_groups_equal(jstore, tstore)
    assert [g.name for g in tstore.groups] == ["parity65", "dected79", "ileave88"]
    masks = tstore.group_host_masks({"attention": 0.55, "mlp": 1.0, "embedding": 0.56})
    assert [m[2].dtype for m in masks] == [torch.uint8, torch.int32, torch.int32]
    assert not any(m.any() for m in masks[1])  # the nominal mlp rail draws nothing
    # one codec: one group aliasing the master planes
    single = tps.PlaneStore(tl, CODEC_KEYS, tv.PLATFORMS["vc707"], codecs="dected79")
    (g,) = single.groups
    assert g.lo is single.lo and g.hi is single.hi and g.check.dtype == torch.int32
    (g,) = tps.PlaneStore(tl, CODEC_KEYS, tv.PLATFORMS["vc707"]).groups
    assert g.check is not None and g.name == "secded72"


def test_set_domain_codec_keeps_the_other_groups(codec_leaves):
    jl, tl = codec_leaves
    kw = dict(seed=2, codecs=MIXED)
    jstore = jps.PlaneStore(jl, CODEC_KEYS, jv.PLATFORMS["vc707"],
                            domain_key=jshapes.domain_of, **kw)
    tstore = tps.PlaneStore(tl, CODEC_KEYS, tv.PLATFORMS["vc707"],
                            domain_key=tshapes.domain_of, **kw)
    before = {g.name: (g.slot_ids, g.check.clone()) for g in tstore.groups}
    volts = {"attention": 0.55, "mlp": 0.56, "embedding": 0.54}
    _, first = tstore.set_rails(volts)
    for store in (jstore, tstore):
        store.set_domain_codec("mlp", "secded72")
        store.set_domain_codec("attention", "parity65")  # unchanged: a no-op
    _assert_groups_equal(jstore, tstore)
    after = {g.name: g for g in tstore.groups}
    assert "dected79" not in after and after["secded72"].codec.n_check == 8
    for name in ("parity65", "ileave88"):
        assert after[name].slot_ids == before[name][0]
        assert torch.equal(after[name].check, before[name][1])
    jf, js = jstore.set_rails(volts)
    tf, ts = tstore.set_rails(volts)
    _assert_codec_leaves_equal(jf, tf)
    for d in ts.domains:
        assert _stats(ts[d]) == _stats(js[d])
    for d in ("attention", "embedding"):  # their masks did not change
        assert _stats(ts[d]) == _stats(first[d])


@pytest.mark.parametrize("codecs,multi", [("dected79", False), ("ileave88", False),
                                          ("parity65", True), (MIXED, True)])
@pytest.mark.parametrize("ecc", [True, False])
def test_codec_walk_bit_identical(codec_leaves, codecs, multi, ecc):
    jl, tl = codec_leaves
    dk = dict(domain_key=jshapes.domain_of) if multi else {}
    tk = dict(domain_key=tshapes.domain_of) if multi else {}
    jstore = jps.PlaneStore(jl, CODEC_KEYS, jv.PLATFORMS["vc707"], seed=4, codecs=codecs, **dk)
    tstore = tps.PlaneStore(tl, CODEC_KEYS, tv.PLATFORMS["vc707"], seed=4, codecs=codecs, **tk)
    _assert_groups_equal(jstore, tstore)
    for v in WALK:
        if multi:
            volts = {"attention": v, "mlp": round(v + 0.01, 2), "embedding": v}
            jf, js = jstore.set_rails(volts, ecc=ecc)
            tf, ts = tstore.set_rails(volts, ecc=ecc)
            assert {d: _stats(ts[d]) for d in ts.domains} == {
                d: _stats(js[d]) for d in js.domains}, v
        else:
            jf, js = jstore.set_voltage(v, ecc=ecc)
            tf, ts = tstore.set_voltage(v, ecc=ecc)
            assert _stats(ts) == _stats(js), v
        _assert_codec_leaves_equal(jf, tf)
    total = ts.total() if multi else ts
    assert total.faulty_words > 0
