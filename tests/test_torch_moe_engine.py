"""Port parity of the MoE family's engines against the reference on smoke
configs: the inline engine (planes, counters, protected keys), the
multi-rail walk, domain mode with the expert leaves in the memory and paged
``serve``; within the port, paged serve against dense ``generate`` at a
capacity nothing exceeds, and the fused matmul's reach (the attention)."""

import dataclasses

import numpy as np
import pytest

import jax

from repro.models import lm as jlm
from repro.serving import engine as jeng
from repro_torch import configs as tconfigs
from repro_torch.core import controller as tctl
from repro_torch.kernels import ops as tops
from repro_torch.models import base as tbase
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as teng
from test_torch_engine_modes import _rels, _same_params, _stats
from test_torch_moe import MAX_LEN, N_NEW, PROMPTS, _one_torch_thread, _pair, models  # noqa: F401
from test_torch_serve import Masks, _assert_reports_equal


def test_inline_engine_matches_reference(models):
    """Planes and counters bit for bit under the host masks; the protected
    keys are the reference's: the attention's wq and wo only (the experts,
    router and shared expert are 3- and 4-D leaves outside its key rule)."""
    cfg, params, tcfg, tparams = models
    for embed in (False, True):
        _, jsizes = jeng.protect_params_inline(params, cfg, include_embed=embed)
        _, tsizes = teng.protect_params_inline(tparams, tcfg, include_embed=embed)
        assert tsizes == jsizes
    assert sorted(k.split("[")[-1].strip("']") for k in tsizes) == ["embed", "wo", "wq"]
    jrel, trel = _rels(platform="vc707", voltage=1.0, mode="inline", rails=dict(start_v=0.62))
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    for v in (0.56, 0.54):
        j.set_voltage(v)
        t.set_voltage(v)
        _same_params(t.params, j.params)
        assert _stats(t._last_scrub) == _stats(j._last_scrub)
        np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))
    assert t._last_scrub.faulty_words > 0
    for e in (j, t):
        e.set_voltage(e.controller.voltage)
    jl, jh = j.autotune_voltage()
    tl, th = t.autotune_voltage()
    rec = lambda h: [(r.voltage, r.corrected, r.detected, r.action) for r in h]
    assert tl == jl and rec(th) == rec(jh)
    assert _stats(t.stats) == _stats(j.stats) and t.power_report() == j.power_report()


def test_multi_rail_walk_matches_reference(models):
    """Two domains hold words (attention, embedding), none the mlp: the
    experts stay plain under the inline key rule."""
    cfg, params, tcfg, tparams = models
    jrel, trel = _rels(platform="vc707", voltage=1.0, mode="inline",
                       rails=dict(multi_rail=True, start_v=0.62))
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    assert set(t._store.domains) == set(j._store.domains) == {"attention", "embedding"}
    jv, jh = j.autotune_voltage()
    tv, th = t.autotune_voltage()
    rec = lambda h: [{f.name: getattr(r, f.name) for f in dataclasses.fields(
        tctl.ControllerRecord)} for r in h]
    assert tv == jv and {d: rec(h) for d, h in th.items()} == {d: rec(h) for d, h in jh.items()}
    assert _stats(t.stats) == _stats(j.stats) and t.power_report() == j.power_report()
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))


@pytest.mark.parametrize("v", [1.0, 0.56])
def test_domain_mode_faults_the_expert_leaves_as_the_reference(models, v):
    """Domain mode writes every leaf, the 4-D expert weights included, and
    reads the tree back through the faults at each voltage step."""
    cfg, params, tcfg, tparams = models
    jrel, trel = _rels(platform="vc707", voltage=v, mode="domain")
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    experts = [k for k in t.domain.names() if "['moe']['w" in k]
    assert len(experts) == 2 + tcfg.gated_mlp
    assert all(len(t.domain.entry(k).shape) == 4
               and t.domain.entry(k).shape[1] == tcfg.n_experts for k in experts)
    _same_params(t.params, j.params)
    assert _stats(t.stats) == _stats(j.stats)
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))
    if v < 0.6:
        assert t.stats.faulty_words > 0
        assert sum(t.domain.read(k, v)[1].faulty_words for k in experts) > 0


def test_llama4_scout_serve_matches_reference(monkeypatch):
    """Paged serve on an inline engine, its KV pages at 0.55 V with the
    same numpy masks in both packages; decode routes every lane, idle ones
    included, as one group."""
    cfg, tcfg = _pair("llama4-scout-17b-a16e")
    assert tconfigs.shapes.supports_paged_kv(tcfg)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tbase.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                      device="cpu")
    jrel, trel = _rels(platform="vc707", voltage=1.0, mode="inline")
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=32)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=32, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, 256, n).astype(np.int32), m)
            for n, m in ((9, 5), (4, 7), (13, 3), (6, 6))]
    masks = Masks(seed=11, scale=6.0).install(monkeypatch)
    kw = dict(n_lanes=3, page_tokens=4, kv_voltage=0.55, scrub_interval=2)
    rt = t.serve(reqs, **kw)
    _assert_reports_equal(j.serve(reqs, **kw), rt)
    assert masks.calls > 0 and rt.kv_stats.corrected > 0
    assert _stats(t.stats) == _stats(j.stats) and t.power_report() == j.power_report()


def test_paged_serve_equals_dense_generate_without_drops():
    """At a capacity no assignment exceeds (cf = E), paged serve equals
    dense ``generate`` of each request alone."""
    _, tcfg = _pair("llama4-scout-17b-a16e", capacity_factor=4.0)
    tparams = tlm.init_params(tcfg, seed=0, device="cpu")
    eng = teng.ServingEngine(tcfg, tparams, rel=None, max_len=32, device="cpu")
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, 256, n).astype(np.int32), m) for n, m in ((9, 5), (4, 7), (13, 3))]
    rep = eng.serve(reqs, n_lanes=2)
    for i, (prompt, n) in enumerate(reqs):
        np.testing.assert_array_equal(np.asarray(rep.outputs[i]), eng.generate(prompt[None], n)[0])


def test_mixtral_paged_serve_is_refused_for_its_window():
    _, tcfg = _pair("mixtral-8x22b")
    assert not tconfigs.shapes.supports_paged_kv(tcfg)
    eng = teng.ServingEngine(tcfg, {}, rel=None, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="paged KV"):
        eng.serve([(np.arange(4, dtype=np.int32), 2)], n_lanes=1)


def test_moe_uses_ecc_matmul_only_on_the_attention(models, monkeypatch):
    """A forward of the inline engine reads the protected attention
    weights through the fused matmul and nothing else."""
    _, _, tcfg, tparams = models
    seen = []
    real = tops.ecc_matmul

    def spy(x, w, *a, **kw):
        seen.append((w.k, w.n))
        return real(x, w, *a, **kw)

    monkeypatch.setattr(tops, "ecc_matmul", spy)
    eng = teng.ServingEngine(tcfg, tparams, rel=teng.ReliabilityConfig(mode="inline"),
                             max_len=MAX_LEN, device="cpu")
    eng.generate(PROMPTS, 2)
    hq = tcfg.n_heads * tcfg.hd
    assert set(seen) == {(tcfg.d_model, hq), (hq, tcfg.d_model)}
    assert len(seen) == 2 * tcfg.n_layers * 2  # wq + wo per layer, prefill + one decode
