"""Mesh serving on the port (tests/test_mesh_serve.py and
tests/test_obs.py::test_mesh_serve_single_causal_trace): a one-shard mesh
engine equals the unsharded engine bit for bit, the guards raise where the
reference's do, and the reference's forced-host-device runs (8 shards, 2
shards with a recorder) run in process, the shards being logical chips on
the CPU. The reference's weights are carried over with ``params_from_numpy``."""

import numpy as np
import pytest
import torch

import jax

from conftest import tiny_cfg
from repro.launch.mesh import make_reliability_mesh as jmesh
from repro.models import lm as jlm
from repro.serving.engine import ReliabilityConfig as JRel
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.launch.mesh import make_reliability_mesh
from repro_torch.models import base as tbase
from repro_torch.obs import TraceRecorder, validate_events
from repro_torch.serving.engine import (
    FaultModelConfig,
    RailsConfig,
    ReliabilityConfig,
    ReliabilityConfigError,
    ServingEngine,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain fault field is many small int64 torch ops: one intra-op
    thread a pytest-xdist worker keeps the workers off each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg(d_model=64, n_layers=2, d_ff=128, vocab=128)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = tbase.ModelConfig(
        name=cfg.name, family=cfg.family, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab,
        head_dim=cfg.head_dim,
    )
    tparams = tbase.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                      device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 100, size=s).astype(np.int32), n)
            for s, n in [(5, 6), (3, 4), (7, 5), (4, 8)]]
    return cfg, params, tcfg, tparams, reqs


def _stream(n, lens=(3, 10), news=(8, 17)):
    rng = np.random.default_rng(0)
    return [(rng.integers(1, 100, size=int(s), dtype=np.int32), int(k))
            for s, k in zip(rng.integers(*lens, size=n), rng.integers(*news, size=n))]


def _rel(policy="uniform", voltage=0.60, start_v=None, mask_source="device", multi=True,
         escalation=None):
    from repro_torch.serving.engine import ProtectionConfig

    return ReliabilityConfig(
        mode="inline", voltage=voltage, seed=1,
        fault_model=FaultModelConfig(mask_source=mask_source),
        rails=RailsConfig(multi_rail=multi, policy=policy, start_v=start_v),
        protection=ProtectionConfig(escalation=escalation),
    )


def cpu_mesh(n):
    return make_reliability_mesh(n, devices=["cpu"] * n)


def _engine(tcfg, tparams, rel, mesh=None, **kw):
    return ServingEngine(tcfg, tparams, rel, max_len=64, device="cpu", mesh=mesh, **kw)


@pytest.mark.parametrize("start_v", [None, 0.57])
def test_engine_mesh_1shard_bit_identical(setup, start_v):
    """A one-shard mesh engine is the unsharded engine: decoded tokens, kv
    counters, weight-rail counters, autotuned schedules and the power
    report. From 0.57 V the weight arena and the kv rail start faulty."""
    _, _, tcfg, tparams, reqs = setup
    e1 = _engine(tcfg, tparams, _rel(start_v=start_v))
    r1 = e1.serve(reqs, n_lanes=2, scrub_interval=2, kv_voltage=0.57, walk_kv=True)
    e2 = _engine(tcfg, tparams, _rel("per_shard", start_v=start_v), mesh=cpu_mesh(1))
    r2 = e2.serve(reqs, n_lanes=2, scrub_interval=2, kv_voltage=0.57, walk_kv=True)
    assert set(r1.outputs) == set(r2.outputs)
    for rid in r1.outputs:
        assert np.array_equal(r1.outputs[rid], r2.outputs[rid]), rid
    assert r1.kv_stats.counters().tolist() == r2.kv_stats.counters().tolist()
    assert r2.shard_of == {rid: 0 for rid in r2.outputs}
    assert r2.kv_voltages_by_shard == [r1.kv_voltages]
    for d in e1.rail_stats.domains:
        assert e1.rail_stats[d].counters().tolist() == e2.rail_stats[d].counters().tolist(), d
    assert e2.shard_stats.n_shards == 1 and e2.shard_stats[0].shard == 0
    if start_v is not None:
        assert e1.stats.corrected > 0
    v1, h1 = e1.autotune_voltage(max_rounds=8)
    v2, h2 = e2.autotune_voltage(max_rounds=8)
    assert v2 == [v1]
    assert {d: [r.voltage for r in h] for d, h in h1.items()} == {
        d: [r.voltage for r in h] for (s, d), h in h2.items()}
    assert all(s == 0 for s, _ in h2)
    p1, p2 = e1.power_report(), e2.power_report()
    assert p2["n_shards"] == 1 and p2["policy"] == "per_shard"
    assert abs(p1["total_w"] - p2["total_w"]) < 1e-9
    assert abs(p1["saving_vs_nominal"] - p2["saving_vs_nominal"]) < 1e-9
    assert abs(p1["bram_w"] - p2["shards"][0]["bram_w"]) < 1e-12


def test_engine_mesh_guards(setup):
    """The port refuses a mesh where the reference does, before any state."""
    cfg, params, tcfg, tparams, _ = setup
    bad = [dict(mask_source="host"), dict(multi=False),
           dict(policy="per_shard", escalation=("secded72", "dected79")),
           dict(policy="per_chip")]
    jmesh1 = jmesh(1)
    for kw in bad:
        jkw = dict(mode="inline", multi_rail=kw.get("multi", True), seed=1, voltage=0.60,
                   mask_source=kw.get("mask_source", "device"),
                   rail_policy=kw.get("policy", "uniform"))
        if "escalation" in kw:
            jkw["escalation"] = kw["escalation"]
        with pytest.raises(AssertionError):
            JEngine(cfg, params, JRel(**jkw), mesh=jmesh1)
        with pytest.raises(ReliabilityConfigError):
            _engine(tcfg, tparams, _rel(**kw), mesh=cpu_mesh(1))
    with pytest.raises(ReliabilityConfigError):
        _engine(tcfg, tparams, None, mesh=cpu_mesh(1))
    # no shard is moved to another kind of device on its own
    with pytest.raises(ValueError):
        _engine(tcfg, tparams, _rel(), mesh=make_reliability_mesh(devices=["cuda:0"] * 2))
    # the escalation ladder is fine under the uniform policy
    _rel(escalation=("secded72", "dected79")).validate(mesh=cpu_mesh(2))


def test_mesh8_serve_acceptance(setup):
    """8 shards on the CPU, per_shard rails, serve(walk_kv) of 16 requests:
    every request served once, shard tags 0-7, per-shard DED counters that
    differ, and the fleet power within 2% of 8 x one chip at equal
    voltage."""
    _, _, tcfg, tparams, _ = setup
    reqs = _stream(16)
    e = _engine(tcfg, tparams, _rel("per_shard", start_v=0.60), mesh=cpu_mesh(8))
    r = e.serve(reqs, n_lanes=2, scrub_interval=1, walk_kv=True)
    rows = [st.counters().tolist() for st in r.kv_stats_by_shard]
    detected = [st.detected for st in r.kv_stats_by_shard]
    assert sorted(r.outputs) == list(range(16))
    assert r.shard_of == {i: i % 8 for i in range(16)}
    for i, (_, n) in enumerate(reqs):
        assert len(r.outputs[i]) == n
    assert [st.shard for st in r.kv_stats_by_shard] == list(range(8))
    assert len(set(detected)) > 1 and sum(detected) > 0, detected
    assert len({tuple(x) for x in rows}) >= 2
    assert e.shard_stats.n_shards == 8 and [s.shard for s in e.shard_stats.by_shard] == \
        list(range(8))
    assert r.kv_stats.counters().tolist() == e.rail_stats["kv"].counters().tolist()
    assert [s["kv"] for s in e.rails] == [v[-1] for v in r.kv_voltages_by_shard]

    e.set_rails({d: 0.56 for d in e._store.domains})
    e1 = _engine(tcfg, tparams, _rel())
    e1.serve(reqs, n_lanes=2, scrub_interval=1, kv_voltage=0.56)
    e1.set_rails({d: 0.56 for d in e1._store.domains})
    e1.rails["kv"] = 0.56
    for s in range(8):
        e.rails[s]["kv"] = 0.56
    p8, p1 = e.power_report()["total_w"], e1.power_report()["total_w"]
    assert p8 == pytest.approx(8 * p1, rel=0.02)
    assert len(e.power_report()["shards"]) == 8


def test_mesh_uniform_policy_shared_walk(setup):
    """The uniform policy on a one-shard mesh walks as the unsharded
    controller; its history carries no shard tag."""
    _, _, tcfg, tparams, _ = setup
    e = _engine(tcfg, tparams, _rel("uniform", start_v=0.62), mesh=cpu_mesh(1))
    schedules, history = e.autotune_voltage(max_rounds=40)
    assert len(schedules) == 1
    ref = _engine(tcfg, tparams, _rel(start_v=0.62))
    v_ref, _ = ref.autotune_voltage(max_rounds=40)
    assert schedules[0] == v_ref
    assert all(shard == -1 for shard, _ in history)


def test_mesh4_uniform_locks_at_the_worst_shard(setup):
    """Four shards: per_shard locks differ across shards somewhere, and the
    uniform lock of each domain is the highest per-shard lock (a shard's DED
    at a voltage does not depend on the walk's history)."""
    _, _, tcfg, tparams, _ = setup
    per = _engine(tcfg, tparams, _rel("per_shard", start_v=0.60), mesh=cpu_mesh(4))
    p_sched, _ = per.autotune_voltage(max_rounds=12)
    uni = _engine(tcfg, tparams, _rel("uniform", start_v=0.60), mesh=cpu_mesh(4))
    u_sched, _ = uni.autotune_voltage(max_rounds=12)
    assert all(s == u_sched[0] for s in u_sched)
    for d in per._store.domains:
        assert u_sched[0][d] == max(s[d] for s in p_sched), d
    assert per.controller.locked_for(per._store.domains)


def test_mesh4_nominal_serve_tokens_equal_unsharded(setup):
    """At nominal rails a 4-shard serve gives every request the unsharded
    serve's tokens: the forward is batch-invariant, so the lanes a request
    shares do not change it."""
    _, _, tcfg, tparams, _ = setup
    reqs = _stream(10, news=(4, 9))
    e1 = _engine(tcfg, tparams, _rel(voltage=1.0))
    r1 = e1.serve(reqs, n_lanes=2, scrub_interval=2)
    e4 = _engine(tcfg, tparams, _rel("per_shard", voltage=1.0), mesh=cpu_mesh(4))
    r4 = e4.serve(reqs, n_lanes=2, scrub_interval=2)
    assert sorted(r4.outputs) == sorted(r1.outputs)
    for rid in r1.outputs:
        assert np.array_equal(r1.outputs[rid], r4.outputs[rid]), rid
    assert r4.kv_stats.corrected == r4.kv_stats.detected == 0
    assert len(e4.kv_arenas) == 4 and [a.shard for a in e4.kv_arenas] == [0, 1, 2, 3]


def test_mesh_serve_single_causal_trace(setup):
    """Serving on a 2-shard mesh with one recorder gives one causally
    ordered trace holding every shard's serve lifecycle, in which every kv
    ``rail_step`` carries its own shard's DED counters."""
    _, _, tcfg, tparams, _ = setup
    reqs = _stream(8, news=(6, 12))
    rec = TraceRecorder()
    e = _engine(tcfg, tparams, _rel("per_shard", voltage=0.58, start_v=0.58),
                mesh=cpu_mesh(2), recorder=rec)
    r = e.serve(reqs, n_lanes=2, scrub_interval=1, walk_kv=True)
    validate_events(rec.events)
    assert sorted(r.outputs) == list(range(8))
    assert all(a["seq"] < b["seq"] for a, b in zip(rec.events, rec.events[1:]))
    kinds = {"serve_begin", "serve_end", "kv_scrub"}
    assert sorted({ev["shard"] for ev in rec.events if ev["kind"] in kinds}) == [0, 1]
    rails = [ev for ev in rec.events if ev["kind"] == "rail_step"]
    assert {ev["shard"] for ev in rails} >= {0, 1}
    assert all(ev["words"] >= 0 and "detected" in ev for ev in rails)
    # a kv rail is fed each interval's scrub of its own shard until it locks
    tripped = 0
    for s in (0, 1):
        kv_rails = [ev for ev in rails if ev["shard"] == s and ev["domain"] == "kv"]
        scrubs = [(ev["corrected"], ev["detected"]) for ev in rec.events
                  if ev["kind"] == "kv_scrub" and ev["shard"] == s]
        assert kv_rails and len(scrubs) >= len(kv_rails)
        assert [(ev["corrected"], ev["detected"]) for ev in kv_rails] == scrubs[:len(kv_rails)]
        tripped += kv_rails[-1]["action"] == "trip+backoff"
    assert tripped > 0 and sum(r.kv_stats.counters()[1:3]) > 0
