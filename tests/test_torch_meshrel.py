"""The port's mesh-sharded reliability layer against the reference's
(tests/test_meshrel.py).

Exact against the reference: the axis conventions, ``pad_to_shards``,
``schedule_rates``, ``ShardFaultStats``, ``MeshRailController`` under both
policies, ``partition_requests``, ``MeshServeReport.merge`` and the mesh
power model. On the port: a one-shard store equals the unsharded
device-mask store bit for bit, the shard streams are disjoint, the KV scrub
step equals the arena's own scrub, and shard 1's weight masks match the
reference's ``fold_in(key, 1)`` stream in distribution (the port's Philox
field equals ``jax.random`` in distribution only)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_cfg
from repro.configs import shapes as jshapes
from repro.core import controller as jctl
from repro.core import telemetry as jtel
from repro.core import voltage as jv
from repro.core.faultsim import _device_chunk_masks
from repro.distributed import meshrel as jmeshrel
from repro.distributed import sharding as jsharding
from repro.launch.mesh import compat_abstract_mesh
from repro.serving import scheduler as jsched
from repro_torch.configs import shapes as tshapes
from repro_torch.core import controller as tctl
from repro_torch.core import faultsim as tfs
from repro_torch.core import kvpages as tkv
from repro_torch.core import telemetry as ttel
from repro_torch.core import voltage as tv
from repro_torch.core.planestore import PlaneStore
from repro_torch.distributed import collectives as tcoll
from repro_torch.distributed import meshrel as tmeshrel
from repro_torch.distributed import sharding as tsharding
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import abstract_mesh, make_reliability_mesh
from repro_torch.models import base as tbase
from repro_torch.serving import scheduler as tsched

CPU = torch.device("cpu")
PROF = tv.PLATFORMS["vc707"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain fault field is many small int64 torch ops: one intra-op
    thread a pytest-xdist worker keeps the workers off each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int):
    return make_reliability_mesh(n, devices=["cpu"] * n)


# -- axis conventions ------------------------------------------------------------


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((2, 4, 4), ("pod", "data", "model")),
                                        ((4,), ("shard",)), ((3, 1), ("data", "model"))])
def test_reliability_axes_conventions(shape, axes):
    j, t = compat_abstract_mesh(shape, axes), abstract_mesh(shape, axes)
    assert tsharding.batch_axes(t) == jsharding.batch_axes(j)
    assert tsharding.reliability_axes(t) == jsharding.reliability_axes(j)
    assert tsharding.reliability_shards(t) == jsharding.reliability_shards(j)
    for n in range(0, 40):
        for k in (1, 2, 3, 4, 8):
            assert tmeshrel.pad_to_shards(n, k) == jmeshrel.pad_to_shards(n, k)


def test_reliability_mesh_placement():
    m = make_reliability_mesh(4, devices=["cpu"] * 4)
    assert m.shape == {"data": 4, "model": 1} and tsharding.reliability_shards(m) == 4
    assert [m.device_of(s) for s in range(4)] == [CPU] * 4
    m2 = make_reliability_mesh(2, model=2, devices=["cpu"] * 4)
    assert m2.shape == {"data": 2, "model": 2} and tsharding.reliability_shards(m2) == 2
    assert make_reliability_mesh(devices=["cpu"] * 3).shape["data"] == 3
    with pytest.raises(ValueError):
        make_reliability_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        abstract_mesh((2,), ("data",)).device_of(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_reliability_mesh()
    # shard 0 keeps the seed; the linear index is row-major over the axes
    mp = abstract_mesh((2, 3, 4), ("pod", "data", "model"))
    assert tcoll.shard_index({"pod": 1, "data": 2, "model": 3}, mp) == 5
    assert tcoll.shard_key(7, {"pod": 0, "data": 0}, mp) == 7
    assert tcoll.shard_key(7, {"pod": 1, "data": 0}, mp) == tcoll.shard_seed(7, 3)
    assert torch.equal(tcoll.psum_counters(torch.ones(3, 2, 8, dtype=torch.int32)),
                       torch.full((2, 8), 3, dtype=torch.int32))


def test_rail_policy_validation():
    for name in ("uniform", "per_shard"):
        assert tshapes.rail_policy(name) == jshapes.rail_policy(name) == name
    assert tctl.RAIL_POLICIES == jctl.RAIL_POLICIES
    for bad in ("per_chip", ""):
        with pytest.raises(AssertionError):
            jshapes.rail_policy(bad)
        with pytest.raises(AssertionError):
            tshapes.rail_policy(bad)


@pytest.mark.parametrize("form", ["dict", "list", "mult"])
def test_schedule_rates_match_reference(form):
    domains = ("attention", "mlp", "embedding")
    tprof = tv.derive_domain_profiles(PROF, domains, spread=0.4, seed=5)
    jprof = jv.derive_domain_profiles(jv.PLATFORMS["vc707"], domains, spread=0.4, seed=5)
    rng = np.random.default_rng(3)
    per = [{d: float(v) for d, v in zip(domains, rng.uniform(0.53, 0.62, 3))} for _ in range(4)]
    sched = per[0] if form == "dict" else per
    mult = rng.uniform(0.5, 2.0, 4) if form == "mult" else None
    t = tmeshrel.schedule_rates(sched, domains, tprof, 4, shard_multipliers=mult)
    j = jmeshrel.schedule_rates(sched, domains, jprof, 4, shard_multipliers=mult)
    assert t.dtype == j.dtype == np.float32 and np.array_equal(t, j)
    assert (t[:, -1] == 0).all()
    for mod, prof in ((tmeshrel, tprof), (jmeshrel, jprof)):
        with pytest.raises(AssertionError):
            mod.schedule_rates(per[:3], domains, prof, 4)
        with pytest.raises(AssertionError):
            mod.schedule_rates({"attention": 0.6}, domains, prof, 4)


# -- telemetry: the shard dimension --------------------------------------------------


def _stats_dict(st):
    """A ShardFaultStats / DomainFaultStats / FaultStats as plain data."""
    if hasattr(st, "by_shard"):
        return [_stats_dict(r) for r in st.by_shard]
    if hasattr(st, "by_domain"):
        return {"shard": st.shard, **{d: _stats_dict(s) for d, s in st.by_domain.items()}}
    return {**st.to_dict(), "tag": st.shard}


def test_shard_fault_stats_match_reference():
    rng = np.random.default_rng(0)
    names = ("a", "b", "c")
    words = [{"a": 10, "b": 20, "c": 7}, {"a": 11, "b": 19, "c": 7}, {"a": 9, "b": 21, "c": 8}]
    blocks = [rng.integers(0, 9, (3, 3, 8)) for _ in range(2)]
    built = {}
    for mod in (jtel, ttel):
        a = mod.ShardFaultStats.from_counter_blocks(blocks[0], names, words)
        b = mod.ShardFaultStats.from_counter_blocks(blocks[1], names, words)
        out = [_stats_dict(a), _stats_dict(a.reduced()), a.total().to_dict(), a.n_shards,
               a.domains, _stats_dict(a[1])]
        a.accumulate(b)
        out.append(_stats_dict(a))
        out.append(_stats_dict(mod.ShardFaultStats.summed([a, b])))
        # growth: rows of a sub-fleet slice keep their own shard tags
        sub = mod.ShardFaultStats([b[2]])
        grown = mod.ShardFaultStats()
        grown.accumulate(sub)
        out.append(_stats_dict(grown))
        # the pure reductions accept containers
        out.append(_stats_dict(mod.DomainFaultStats.summed([a[0], a[1]])))
        out.append(_stats_dict(mod.DomainFaultStats.summed([a[1], a[1]])))
        out.append(mod.FaultStats.summed([a]).to_dict())
        out.append(mod.FaultStats.summed([a[0], a[2]]).to_dict())
        built[mod.__name__] = out
    assert built["repro.core.telemetry"] == built["repro_torch.core.telemetry"]
    st = ttel.ShardFaultStats.from_counter_blocks(blocks[0], names, words)
    assert st[0]["a"].shard == 0 and st.reduced().shard == -1 and st.reduced()["a"].shard == -1
    assert st.reduced()["a"].words == 30


# -- the mesh rail controller -----------------------------------------------------


def _shard_stats(mod, per_shard_detected, domain="mlp", words=1000, corrected=None):
    corrected = corrected or [0] * len(per_shard_detected)
    return mod.ShardFaultStats([
        mod.DomainFaultStats({domain: mod.FaultStats(words=words, detected=d, corrected=c,
                                                     shard=s)}, shard=s)
        for s, (d, c) in enumerate(zip(per_shard_detected, corrected))
    ])


def _records(ctrl):
    return {k: [{f.name: getattr(r, f.name) for f in dataclasses.fields(tctl.ControllerRecord)}
                for r in recs] for k, recs in ctrl.history.items()}


@pytest.mark.parametrize("policy", ["uniform", "per_shard"])
@pytest.mark.parametrize("seed", range(3))
def test_mesh_controller_matches_reference(policy, seed):
    rng = np.random.default_rng(seed)
    n = 4
    jc = jctl.MeshRailController(jv.PLATFORMS["vc707"], ("attention", "mlp"), n,
                                 policy=policy, start_v=0.62)
    tc = tctl.MeshRailController(PROF, ("attention", "mlp"), n, policy=policy, start_v=0.62)
    jr, tr = jc.add_rail("kv", codec="secded72"), tc.add_rail("kv", codec="secded72")
    assert len(jr) == len(tr) == n
    assert (jr[0] is jr[-1]) == (tr[0] is tr[-1]) == (policy == "uniform")
    for step in range(14):
        det = [rng.integers(0, 3) if rng.random() < 0.15 else 0 for _ in range(n)]
        dom = ("attention", "mlp", "kv")[step % 3]
        div = [float(x) for x in rng.random(n)] if step % 4 == 0 else None
        j = jc.update(_shard_stats(jtel, det, dom), divergence=div)
        t = tc.update(_shard_stats(ttel, det, dom), divergence=div)
        assert t == j and tc.voltages == jc.voltages
        assert tc.locked == jc.locked
        assert tc.locked_for(("attention", "mlp")) == jc.locked_for(("attention", "mlp"))
    assert _records(tc) == _records(jc)
    assert tc.codecs == jc.codecs
    if policy == "uniform":
        # a reduced view is accepted, and the history carries no shard tag
        tc.update(_shard_stats(ttel, [0, 0, 5, 0]).reduced())
        jc.update(_shard_stats(jtel, [0, 0, 5, 0]).reduced())
        assert tc.voltages == jc.voltages and tc.pop_codec_changes() == jc.pop_codec_changes()
        assert all(s == -1 for s, _ in tc.history)
        return
    assert all(r.shard == s for (s, _), recs in tc.history.items() for r in recs)
    for mod, c in ((jtel, jc), (ttel, tc)):
        with pytest.raises(AssertionError):
            c.update(_shard_stats(mod, [0, 0]))  # wrong shard count
        with pytest.raises(AssertionError):
            c.update(_shard_stats(mod, [0] * n).reduced())  # collapsed rows
        with pytest.raises(AssertionError):
            c.pop_codec_changes()  # per-shard ladders unsupported


def test_mesh_controller_uniform_worst_shard_lock():
    ctrl = tctl.MeshRailController(PROF, ("mlp",), n_shards=4, policy="uniform")
    ctrl.update(_shard_stats(ttel, [0, 0, 0, 0]))
    v_before = ctrl.voltages[0]["mlp"]
    ctrl.update(_shard_stats(ttel, [0, 0, 7, 0]))
    assert ctrl.locked
    assert all(v["mlp"] == ctrl.voltages[0]["mlp"] > v_before - 0.01 for v in ctrl.voltages)
    # one shard: the per_shard walk is the MultiRailController's
    one = tctl.MeshRailController(PROF, ("mlp",), n_shards=1, policy="per_shard")
    solo = tctl.MultiRailController(PROF, ("mlp",))
    for det in (0, 0, 3, 0):
        one.update(_shard_stats(ttel, [det]))
        solo.update({"mlp": ttel.FaultStats(words=1000, detected=det)})
    assert one.voltages[0]["mlp"] == solo.voltages["mlp"] and one.locked == solo.locked


# -- request partitioning, merged reports, fleet power -------------------------------


def test_partition_requests_match_reference():
    pairs = [(np.arange(1, 4, dtype=np.int32), 2) for _ in range(7)]
    for n in (1, 2, 3, 8):
        j = jsched.partition_requests(jsched.normalize_requests(pairs), n)
        t = tsched.partition_requests(tsched.normalize_requests(pairs), n)
        assert [[r.rid for r in p] for p in t] == [[r.rid for r in p] for p in j]
    assert [[r.rid for r in p] for p in t] != []
    assert [r.rid for r in tsched.partition_requests(tsched.normalize_requests(pairs), 1)[0]] \
        == list(range(7))


def test_mesh_serve_report_merge_matches_reference():
    def rep(mod, tel, rids, detected, volts):
        return mod.ServeReport(
            outputs={r: np.full(2, r, np.int32) for r in rids},
            request_stats={r: tel.FaultStats(words=r) for r in rids},
            kv_stats=tel.FaultStats(words=10, detected=detected, corrected=len(rids)),
            steps=3 + len(rids), preemptions=1, kv_voltages=volts, arena=None,
            pages_free_at_end=0,
        )

    out = {}
    for mod, tel in ((jsched, jtel), (tsched, ttel)):
        m = mod.MeshServeReport.merge([rep(mod, tel, [0, 2], 1, [1.0, 0.99]),
                                       rep(mod, tel, [1], 5, [0.6])])
        out[mod.__name__] = (
            {k: v.tolist() for k, v in m.outputs.items()}, m.shard_of,
            {k: v.to_dict() for k, v in m.request_stats.items()}, m.kv_stats.to_dict(),
            [s.to_dict() for s in m.kv_stats_by_shard], m.kv_voltages_by_shard, m.steps,
            m.preemptions)
        with pytest.raises(AssertionError):
            mod.MeshServeReport.merge([rep(mod, tel, [0], 0, []), rep(mod, tel, [0], 0, [])])
    assert out["repro.serving.scheduler"] == out["repro_torch.serving.scheduler"]
    assert out["repro_torch.serving.scheduler"][4][1]["shard"] == 1


def test_mesh_power_matches_reference():
    rng = np.random.default_rng(1)
    doms = ("attention", "mlp", "embedding", "kv")
    scheds = [{d: float(v) for d, v in zip(doms, rng.uniform(0.54, 1.0, 4))} for _ in range(5)]
    words = [{d: int(w) for d, w in zip(doms, rng.integers(1, 10**6, 4))} for _ in range(5)]
    bits = {"attention": 7, "mlp": 15, "embedding": 8, "kv": 24}
    for ecc in (True, False):
        for cb in (None, bits):
            j = jv.mesh_bram_power(scheds, words, ecc=ecc, check_bits=cb)
            t = tv.mesh_bram_power(scheds, words, ecc=ecc, check_bits=cb)
            assert abs(t - j) <= 1e-12 * abs(j)
            j = jv.mesh_power_saving(scheds, words, ecc=ecc, check_bits=cb)
            t = tv.mesh_power_saving(scheds, words, ecc=ecc, check_bits=cb)
            assert abs(t - j) <= 1e-12 * max(abs(j), 1e-30)
    with pytest.raises(AssertionError):
        tv.mesh_bram_power(scheds, words[:4])


# -- the sharded plane arena ----------------------------------------------------------


KEYS = ["w_attn", "w_mlp", "w_embed"]


@pytest.fixture(scope="module")
def leaves():
    rng = np.random.default_rng(0)
    return [tops.pack_ecc_weights(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
            for s in ((64, 128), (64, 64), (128, 64))]


def _store(leaves, mesh=None, keys=KEYS, **kw):
    return PlaneStore(leaves, keys, PROF, seed=3, mask_source="device",
                      domain_key=lambda k: k.split("_")[1], mesh=mesh, device="cpu", **kw)


def _assert_same_step(l1, d1, l2, s2):
    for a, b in zip(l1, l2):
        assert torch.equal(a.lo, b.lo) and torch.equal(a.hi, b.hi)
        assert torch.equal(a.parity, b.parity)
    assert s2.n_shards == 1
    for d in d1.domains:
        assert d1[d].counters().tolist() == s2[0][d].counters().tolist(), d
        assert d1[d].words == s2[0][d].words and s2[0][d].shard == 0


def test_sharded_1shard_bit_identical_to_unsharded(leaves):
    ref, sh = _store(leaves), _store(leaves, cpu_mesh(1))
    assert sh.n_shards == 1 and ref.n_shards == 0
    faulty = 0
    for volts in ({"attn": 0.58, "mlp": 0.58, "embed": 0.58},
                  {"attn": 0.55, "mlp": 0.60, "embed": 0.57},
                  {"attn": 0.545, "mlp": 0.545, "embed": 0.58}):
        l1, d1 = ref.set_rails(volts)
        l2, s2 = sh.set_rails_sharded(volts)
        _assert_same_step(l1, d1, l2, s2)
        faulty += d1.total().faulty_words
    assert faulty > 0


def test_sharded_1shard_bit_identical_multi_codec_groups(leaves):
    mk = lambda mesh=None: _store(leaves[:2], mesh, keys=KEYS[:2], codecs={"mlp": "dected79"})
    ref, sh = mk(), mk(cpu_mesh(1))
    assert len(sh.groups) == 2
    for volts in ({"attn": 0.55, "mlp": 0.55}, {"attn": 0.54, "mlp": 0.56}):
        l1, d1 = ref.set_rails(volts)
        l2, s2 = sh.set_rails_sharded(volts)
        _assert_same_step(l1, d1, l2, s2)
        assert d1.total().faulty_words > 0


def test_sharded_schedule_forms_equivalent(leaves):
    store = _store(leaves, cpu_mesh(3))
    volts = {"attn": 0.56, "mlp": 0.58, "embed": 0.57}
    per = [volts, {**volts, "mlp": 0.55}, volts]
    _, a = store.set_rails_sharded(per)
    _, b = store.set_rails_sharded({d: np.array([p[d] for p in per]) for d in volts})
    _, c = store.set_rails_sharded(volts)
    for s in range(3):
        assert a[s].domains == store.domains
        for d in a.domains:
            assert a[s][d].counters().tolist() == b[s][d].counters().tolist()
    assert sum(c[s][d].words for s in range(3) for d in c.domains) == store.n_words
    norm = store._normalize_schedule(volts)
    norm[0]["attn"] = 0.0  # independent dicts
    assert norm[1]["attn"] == 0.56
    with pytest.raises(AssertionError):
        store._normalize_schedule([volts, volts])


def test_sharded_store_guards(leaves):
    with pytest.raises(AssertionError):
        PlaneStore(leaves, KEYS, PROF, mask_source="host", mesh=cpu_mesh(1), device="cpu")
    store = _store(leaves, cpu_mesh(1))
    with pytest.raises(AssertionError):
        store.set_rails({"attn": 0.6, "mlp": 0.6, "embed": 0.6})
    with pytest.raises(AssertionError):
        store.set_voltage(0.6)
    with pytest.raises(AssertionError):
        _store(leaves).set_rails_sharded({"attn": 0.6, "mlp": 0.6, "embed": 0.6})


def test_sharded_store_counts_every_word_once(leaves):
    """Four shards over 4,352 words: every word counted in its shard's row
    once, pad words in none, the per-shard counter block summing to the
    reduced view, and the shards' rows differing."""
    store = _store(leaves, cpu_mesh(4))
    volts = {"attn": 0.54, "mlp": 0.54, "embed": 0.54}
    leaves_, st = store.set_rails_sharded(volts)
    words = store.shard_words_by_domain()
    for s in range(4):
        for d in store.domains:
            row = st[s][d]
            assert row.words == words[s][d]
            assert row.clean + row.corrected + row.detected + row.silent <= row.words
            assert row.clean + row.words_1bit + row.words_2bit + row.words_multi == row.words
    red = st.reduced()
    assert [red[d].words for d in store.domains] == [1024, 512, 1024]
    assert len({tuple(st[s].total().counters()) for s in range(4)}) > 1
    # a shard's slice of the faulty planes is what its own field and B2 give
    g = store.groups[0]
    sg = g.sharded
    rates = tmeshrel.schedule_rates(volts, store.domains,
                                    {d: store.domain_profile(d) for d in store.domains}, 4)
    L = sg.local_words
    for s, f in enumerate(sg.fields):
        cut = slice(s * L, (s + 1) * L)
        rate_w = torch.from_numpy(rates[s])[sg.dom[cut].long()]
        masks = tops.fault_field(f.f_row, rate_w, f.key, 8)
        flo, _, fchk, cnt = tops.inject_scrub_domains(sg.lo[cut], sg.hi[cut], sg.check[cut],
                                                      *masks, sg.dom[cut], 3)
        off = store.groups[0].offsets
        whole = torch.cat([w.lo.reshape(-1) for w in leaves_])
        assert torch.equal(whole[cut.start:min(cut.stop, store.n_words)],
                           flo[: max(0, min(L, store.n_words - s * L))])
        assert cnt.tolist() == [st[s][d].counters().tolist() for d in store.domains]
        assert off[0] == 0


# -- per-shard stream disjointness --------------------------------------------------


def test_weight_shard_streams_disjoint_100_step_walk():
    """No shard reproduces another's weight masks at any step of a 100-step
    walk; every compared step must be non-empty for every shard."""
    fields = tmeshrel.shard_fields(cpu_mesh(4), 4096, 3, PROF.row_sigma)
    nonzero = 0
    for vi, v in enumerate(np.linspace(0.57, PROF.v_crash, 100)):
        rate = float(np.float32(PROF.fault_rate(float(v))))
        sigs, empty = set(), False
        for f in fields:
            m = tops.fault_field(f.f_row, rate, f.key, 8) if rate else None
            if m is None or not any(bool(x.any()) for x in m):
                empty = True
                continue
            sig = tuple(x.numpy().tobytes() for x in m)
            assert sig not in sigs, f"shard mask collision at step {vi} (v={v:.3f})"
            sigs.add(sig)
        nonzero += not empty
    assert nonzero >= 60, nonzero
    assert len({f.key for f in fields}) == 4


def test_kv_shard_streams_disjoint_100_intervals():
    cfg = tiny_cfg()
    tcfg = tbase.ModelConfig(name=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
                             d_model=cfg.d_model, n_heads=cfg.n_heads,
                             n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab,
                             head_dim=cfg.head_dim)
    geom = tkv.KVGeometry.from_config(tcfg, page_tokens=4)

    def arena(shard=None):
        kw = {} if shard is None else {"shard": shard}
        a = tkv.KVPageArena(geom, PROF, n_pages=2, seed=7, device="cpu", **kw)
        a.set_voltage(0.55)
        return a

    legacy, arenas = arena(), [arena(s) for s in range(3)]
    assert legacy.shard == 0
    for step in range(100):
        sigs = set()
        for a in [legacy] + arenas:
            before = [t.clone() for t in (a.lo, a.hi, a.parity)]
            a.tick()
            mask = tuple((x ^ b).numpy().tobytes() for x, b in zip((a.lo, a.hi, a.parity),
                                                                 before))
            if a is legacy:
                legacy_mask = mask
                continue
            if a is arenas[0]:
                assert mask == legacy_mask, f"shard 0 left the unsharded stream at {step}"
            assert mask not in sigs, f"kv mask collision at interval {step}"
            sigs.add(mask)
    keys = {tfs.interval_key(tcoll.shard_seed(7, s), i) for s in range(8) for i in range(1, 101)}
    assert len(keys) == 800


def test_kv_scrub_step_matches_arena_scrub():
    cfg = tiny_cfg()
    tcfg = tbase.ModelConfig(name=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
                             d_model=cfg.d_model, n_heads=cfg.n_heads,
                             n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab,
                             head_dim=cfg.head_dim)
    geom = tkv.KVGeometry.from_config(tcfg, page_tokens=4)
    rng = np.random.default_rng(1)
    arenas = []
    for s in range(2):
        a = tkv.KVPageArena(geom, PROF, n_pages=3, seed=11, device="cpu", shard=s)
        payload = torch.from_numpy(rng.standard_normal((4, geom.token_f32)).astype(np.float32))
        a.commit_tokens(payload, np.array([0, 0, 1, 2]), np.array([0, 1, 0, 0]))
        a.set_voltage(0.545)
        a.tick()
        arenas.append(a)
    tables = np.array([[0, 1, 2, 3], [2, 2, 0, 3]], np.int32)
    L = arenas[0]._total_words
    planes = [torch.cat([getattr(a, n) for a in arenas]) for n in ("lo", "hi", "parity")]
    step = tmeshrel.make_kv_scrub_step(cpu_mesh(2), geom.words_per_page, L, tables.shape[1])
    lo, hi, par, payload, cnt = step(*planes, tables)
    assert lo is planes[0]  # written back in place
    faulty = 0
    for s, a in enumerate(arenas):
        apay, acnt = a.scrub_pages(tables[s])
        assert np.array_equal(cnt[s].numpy(), acnt)
        assert torch.equal(payload[s], apay.reshape(payload[s].shape))
        for p, n in zip((lo, hi, par), ("lo", "hi", "parity")):
            assert torch.equal(p[s * L:(s + 1) * L], getattr(a, n))
        faulty += int(acnt[:, 1:3].sum())
    assert faulty > 0
    _, _, _, cnt2 = tmeshrel.make_kv_scrub_step(cpu_mesh(2), geom.words_per_page, L, 4,
                                                with_payload=False)(*planes, tables)
    assert cnt2.shape == (2, 4, 8)


@pytest.mark.parametrize("voltage", [0.56, 0.55, 0.54])
def test_shard1_weight_masks_match_reference_stream_in_distribution(voltage):
    """Shard 1's field (``shard_seed``) against the reference's shard-1
    stream (``fold_in(key, 1)``, chunk 0): one model, two streams, held to
    the device-field bounds: total flips within 0.6-1.6x, the multi-bit
    share of faulty words within 0.1."""
    n = 1 << 18
    rate = PROF.fault_rate(voltage)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3 ^ 0xECC), 1), 0)
    j = _device_chunk_masks(key, n, jnp.float32(rate), jnp.float32(PROF.row_sigma))
    jflips = sum(tfs._popcount32(np.asarray(x).astype(np.uint32)) for x in j)
    f = tmeshrel.shard_fields(cpu_mesh(2), n, 3, PROF.row_sigma)[1]
    t = tops.fault_field(f.f_row, float(np.float32(rate)), f.key, 8)
    tflips = sum(tfs._popcount32(x.numpy().view(np.uint32) if x.dtype == torch.int32
                                 else x.numpy().astype(np.uint32)) for x in t)
    assert jflips.sum() > 100
    assert 0.6 < tflips.sum() / jflips.sum() < 1.6, (voltage, tflips.sum(), jflips.sum())
    frac = lambda c: (c >= 2).sum() / max((c >= 1).sum(), 1)
    assert abs(frac(jflips) - frac(tflips)) < 0.1


def test_mesh_steps_profile_under_the_references_row_names(leaves):
    """The rail step and the KV scrub step go through the dispatch profiler
    under ``mesh.rail_step`` and ``mesh.kv_scrub_step`` (plain on the CPU);
    with the profiler off they return the same results."""
    from repro_torch.obs import profile as obs_profile

    store = _store(leaves, cpu_mesh(2))
    volts = {"attn": 0.55, "mlp": 0.55, "embed": 0.55}
    _, off = store.set_rails_sharded(volts)
    prof = obs_profile.enable()
    try:
        _, on = store.set_rails_sharded(volts)
        step = tmeshrel.make_kv_scrub_step(cpu_mesh(2), 4, 8, 1)
        planes = [torch.zeros(16, dtype=torch.int32), torch.zeros(16, dtype=torch.int32),
                  torch.zeros(16, dtype=torch.uint8)]
        step(*planes, np.array([[0], [1]], np.int32))
    finally:
        obs_profile.disable()
    assert prof.rows["mesh.rail_step"]["calls"] == len(store.groups)
    assert prof.rows["mesh.kv_scrub_step"]["calls"] == 1
    assert {prof.rows[k]["backend"] for k in ("mesh.rail_step", "mesh.kv_scrub_step")} == {
        "plain"}
    assert [_stats_dict(off[s]) for s in range(2)] == [_stats_dict(on[s]) for s in range(2)]
