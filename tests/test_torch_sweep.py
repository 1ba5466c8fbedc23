"""The port's sweeps (``repro_torch.core.sweep``): bit for bit against its
own device field and inject+scrub loop and against a device-mask plane
store's telemetry, shard 0 against the unsharded sweep, aging drift across
shards, and against the reference's sweeps in distribution (the reference
draws with ``jax.random``, the port with its Philox field kernel)."""

import json

import numpy as np
import pytest
import torch

from repro.core import scenario as jscen
from repro.core import sweep as jsweep
from repro.core.voltage import PLATFORMS as JPLATFORMS
from repro_torch import codes
from repro_torch.configs import get_smoke_config, shapes
from repro_torch.core import scenario, sweep
from repro_torch.core.faultsim import DeviceFaultField
from repro_torch.core.planestore import PlaneStore
from repro_torch.core.voltage import PLATFORMS
from repro_torch.kernels import ops
from repro_torch.models import base, lm
from repro_torch.serving.engine import protect_params_inline

PROF = PLATFORMS["vc707"]
GRID = [(PROF, 0.58), (PROF, 0.56), (PROF, 0.55), (PROF, 0.54),
        (PLATFORMS["kc705a"], 0.55), (PROF, 1.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain fault field is many small int64 torch ops: under
    pytest-xdist, workers that each run a thread per core contend for the
    cores; one intra-op thread a worker avoids that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop(grid, n_words, seed=0, codec="secded72", burst=None, mult=1.0):
    """The per-point loop the sweep stands for: one field per platform (its
    row weakness kept), one draw and one inject+scrub on zeros per point."""
    c = codes.get(codec)
    fields, rows = {}, []
    for p, v in grid:
        f = fields.setdefault(p.name, DeviceFaultField(p, n_words, seed=seed, n_check=c.n_check,
                                                       burst=burst, device="cpu"))
        rate = np.float32(p.fault_rate(v)) * np.float32(mult)
        z = (torch.zeros(n_words, dtype=torch.int32), torch.zeros(n_words, dtype=torch.int32),
             torch.zeros(n_words, dtype=c.check_torch_dtype))
        rows.append(ops.inject_scrub(*z, *f.masks_for_rates(float(rate)), codec=codec)[3]
                    .tolist())
    return rows


def test_platform_grid_equals_the_per_point_loop():
    sweep.reset_dispatch_count()
    pts = sweep.sweep_platform_grid(GRID, 3000, seed=3, device="cpu")
    assert [p.stats.counters().tolist() for p in pts] == _loop(GRID, 3000, seed=3)
    assert [(p.platform, p.voltage) for p in pts] == [(p.name, v) for p, v in GRID]
    assert all(p.stats.words == 3000 for p in pts)
    assert pts[-1].stats.faulty_words == 0 and pts[3].stats.detected > 0
    # one draw per point below V_min; FIP: the faulty set grows down the rail
    assert sweep.dispatch_count() == 5
    assert [p.stats.faulty_bits for p in pts[:4]] == sorted(p.stats.faulty_bits for p in pts[:4])


@pytest.mark.parametrize("env_name", ["avionics", None])
def test_codec_schemes_equal_the_per_point_loop(env_name):
    env = scenario.ENVIRONMENTS[env_name] if env_name else None
    grid = GRID[:4]
    rows = sweep.sweep_codec_schemes(codes.names(), grid, 2048, seed=1, env=env, device="cpu")
    assert len(rows) == 4 * len(grid)
    for cname in codes.names():
        got = [r for r in rows if r["codec"] == cname]
        want = _loop(grid, 2048, seed=1, codec=cname, burst=scenario.active_burst(env),
                     mult=env.rate_multiplier if env else 1.0)
        lanes = ("clean", "corrected", "detected", "silent")
        assert [[r[k] for k in ("corrected", "detected", "silent", "faulty_bits")]
                for r in got] == [[w[1], w[2], w[3], w[7]] for w in want]
        for r in got:
            assert r["check_bits"] == codes.get(cname).n_check
            assert ("environment" in r) == (env is not None)
            assert all(k in r for k in lanes[1:])


def test_secded_scheme_row_equals_the_platform_row():
    rows = sweep.sweep_codec_schemes(["secded72"], GRID, 2048, seed=2, device="cpu")
    pts = sweep.sweep_platform_grid(GRID, 2048, seed=2, device="cpu")
    for r, p in zip(rows, pts):
        assert {k: r[k] for k in p.stats.coverage_row()} == p.stats.coverage_row()


def test_rail_schedules_equal_the_device_store():
    """Per-domain schedules against a device-mask multi-domain store's own
    telemetry at those rails, bit for bit."""
    cfg = get_smoke_config("qwen3-0.6b")
    clean, _ = protect_params_inline(lm.init_params(cfg, seed=0, device="cpu"), cfg,
                                     include_embed=True)
    eccs = [(k, w) for k, w in base.flatten(clean) if isinstance(w, ops.EccWeight)]
    store = PlaneStore([w for _, w in eccs], [k for k, _ in eccs], PROF, seed=4,
                       mask_source="device", domain_key=shapes.domain_of, device="cpu")
    schedules = [{"attention": 0.56, "mlp": 0.55, "embedding": 1.0},
                 {d: 0.54 for d in store.domains}, {d: PROF.v_min for d in store.domains}]
    sweep.reset_dispatch_count()
    got = sweep.sweep_rail_schedules(schedules, store.domains, store.dom_ids,
                                     {d: store.domain_profile(d) for d in store.domains},
                                     seed=store.seed, device="cpu")
    assert sweep.dispatch_count() == 2  # the fault-free schedule draws nothing
    for s, g in zip(schedules, got):
        _, want = store.set_rails(s)
        assert {d: st.to_dict() for d, st in g.by_domain.items()} == \
            {d: st.to_dict() for d, st in want.by_domain.items()}
    assert got[0]["attention"].faulty_words > 0 and got[0]["embedding"].faulty_words == 0
    assert got[2].total().faulty_words == 0


def test_shard0_equals_the_unsharded_sweep():
    grid = [(PROF, v) for v in (0.58, 0.56, 0.545)]
    plain = sweep.sweep_platform_grid(grid, 4096, seed=5, device="cpu")
    per_shard = sweep.sweep_platform_grid_sharded(grid, 4096, 3, seed=5, device="cpu")
    assert len(per_shard) == 3
    for a, b in zip(plain, per_shard[0]):
        assert a.stats.counters().tolist() == b.stats.counters().tolist() and b.stats.shard == 0
    assert any(per_shard[s][-1].stats.counters().tolist() != plain[-1].stats.counters().tolist()
               for s in (1, 2))
    deep = sweep.shard_vmin_spread(PROF, [PROF.v_crash], 1 << 14, 2, seed=5, device="cpu")
    assert deep == [None, None]
    assert sweep.sweep_platform_grid_sharded(grid, 64, 0, device="cpu") == []


def test_aging_spreads_the_shards_vmins():
    voltages = np.round(np.arange(0.60, 0.539, -0.005), 3)
    kw = dict(seed=5, device="cpu")
    aged = sweep.shard_vmin_spread(PROF, voltages, 1 << 13, 6,
                                   env=scenario.resolve(None, drift=0.5), age=300.0, **kw)
    base_ = sweep.shard_vmin_spread(PROF, voltages, 1 << 13, 6, **kw)
    zero = sweep.shard_vmin_spread(PROF, voltages, 1 << 13, 6,
                                   env=scenario.resolve(None, drift=0.0), age=300.0, **kw)
    assert len({v for v in aged if v is not None}) >= 2, aged
    assert zero == base_ and any(a != b for a, b in zip(aged, base_))
    # age 0 gives the plain sweep
    grid = [(PROF, 0.55)]
    at0 = sweep.sweep_platform_grid_sharded(grid, 4096, 2, env=scenario.resolve(None, drift=0.5),
                                            age=0.0, **kw)
    plain = sweep.sweep_platform_grid_sharded(grid, 4096, 2, **kw)
    assert [[p.stats.to_dict() for p in s] for s in at0] == \
        [[p.stats.to_dict() for p in s] for s in plain]


def test_the_reference_grids_in_distribution():
    """The reference's own bounds between its device and host fields:
    faulty bits within 0.6-1.6x, the multi-bit share of faulty words within
    0.1 where more than 50 bits flip; ileave88 beats secded72 under bursts
    in both packages."""
    n = 1 << 16
    grid = [(PROF, v) for v in (0.56, 0.55, 0.54)]
    jgrid = [(JPLATFORMS["vc707"], v) for v in (0.56, 0.55, 0.54)]
    for t, j in zip(sweep.sweep_platform_grid(grid, n, device="cpu"),
                    jsweep.sweep_platform_grid(jgrid, n)):
        assert j.stats.faulty_bits > 50
        assert 0.6 <= t.stats.faulty_bits / j.stats.faulty_bits <= 1.6, (t.stats, j.stats)
        share = lambda s: s.words_multi / max(s.faulty_words, 1)
        assert abs(share(t.stats) - share(j.stats)) <= 0.1
    env = scenario.ENVIRONMENTS["avionics"]
    v = scenario.scenario_voltage(PROF, env)
    trows = sweep.sweep_codec_schemes(("secded72", "ileave88"), [(PROF, v)], n, env=env,
                                      device="cpu")
    jrows = jsweep.sweep_codec_schemes(("secded72", "ileave88"), [(JPLATFORMS["vc707"], v)], n,
                                       env=jscen.ENVIRONMENTS["avionics"])
    for rows in (trows, jrows):
        sec, ilv = rows
        assert sec["faulty_words"] > 50
        assert ilv["coverage_correctable"] > sec["coverage_correctable"]
        assert ilv["detected"] < sec["detected"]
    for t, j in zip(trows, jrows):
        assert 0.6 <= t["faulty_bits"] / j["faulty_bits"] <= 1.6, (t, j)


def test_main_writes_the_reference_columns(tmp_path):
    out = tmp_path / "sweep.json"
    sweep.main(["--words", "4096", "--out", str(out)], device="cpu")
    rows = json.loads(out.read_text())
    jout = tmp_path / "ref.json"
    jsweep.main(["--words", "4096", "--out", str(jout)])
    jrows = json.loads(jout.read_text())
    assert len(rows) == len(jrows) == len(sweep.paper_grid())
    for t, j in zip(rows, jrows):
        assert set(t) == set(j) and set(t["coverage"]) == set(j["coverage"])
        assert (t["platform"], t["voltage"], t["words"]) == (j["platform"], j["voltage"], 4096)


def test_oversized_sweeps_are_refused():
    for n in (0, 1 << 31):
        with pytest.raises(ValueError, match="2\\^31"):
            sweep.sweep_platform_grid(GRID, n, device="cpu")


def test_rail_schedules_refuse_domains_of_two_row_fields():
    """The domains of one arena draw from one row-weakness field: profiles
    with different row sigmas are refused."""
    import dataclasses

    other = dataclasses.replace(PROF, row_sigma=PROF.row_sigma * 2)
    with pytest.raises(ValueError, match="row-weakness"):
        sweep.sweep_rail_schedules([{"a": 0.55, "b": 0.55}], ("a", "b"),
                                   torch.zeros(64, dtype=torch.int32),
                                   {"a": PROF, "b": other}, device="cpu")
