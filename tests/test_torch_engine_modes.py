"""Port parity of the serving engine's per-leaf inline path
(``FaultModelConfig(batched=False)``) and of domain mode on the tiny config
against the reference engine: parameters, counters, tokens, locks and
power; and ``validate()`` over the mode / batched / rail combinations."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax

from conftest import tiny_cfg
from test_torch_serve import MIXED, PT, Masks, _assert_reports_equal
from repro.models import lm as jlm
from repro.serving import engine as jeng
from repro_torch.kernels import ops as tops
from repro_torch.models import base as tbase
from repro_torch.serving import engine as teng

PROMPTS = np.random.default_rng(0).integers(0, 128, (2, 8)).astype(np.int32)
N_NEW = 6


def _port_cfg():
    c = tiny_cfg()
    return tbase.ModelConfig(
        name=c.name, family=c.family, n_layers=c.n_layers, d_model=c.d_model,
        n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, d_ff=c.d_ff, vocab=c.vocab,
        head_dim=c.head_dim,
    )


@pytest.fixture(scope="module")
def models():
    cfg = tiny_cfg()
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), _port_cfg(), device="cpu"
    )
    return cfg, params, _port_cfg(), tparams


def _rels(**kw):
    """The same config in both packages: (reference, port)."""
    fm = kw.pop("fault_model", {})
    prot = kw.pop("protection", {})
    rails = kw.pop("rails", {})
    return (
        jeng.ReliabilityConfig(fault_model=jeng.FaultModelConfig(**fm),
                               protection=jeng.ProtectionConfig(**prot),
                               rails=jeng.RailsConfig(**rails), **kw),
        teng.ReliabilityConfig(fault_model=teng.FaultModelConfig(**fm),
                               protection=teng.ProtectionConfig(**prot),
                               rails=teng.RailsConfig(**rails), **kw),
    )


def _bytes(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _leaves(params) -> list:
    """Every leaf's bytes in flattening order; an ECC leaf gives its three
    planes and its scale."""
    out = []
    for _, leaf in tbase.flatten(params, is_leaf=lambda x: not isinstance(x, dict)):
        if isinstance(leaf, (tops.EccWeight, jeng.kops.EccWeight)):
            out += [_bytes(p) for p in (leaf.lo, leaf.hi, leaf.parity, leaf.scale)]
        else:
            out.append(_bytes(leaf))
    return out


def _same_params(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _stats(s) -> dict:
    return dataclasses.asdict(s)


# -- the per-leaf inline path ---------------------------------------------------
PER_LEAF = [
    ("ecc", dict(ecc=True), (0.56, 0.54)),
    ("no_ecc", dict(ecc=False), (0.55,)),
    ("embed", dict(ecc=True, protection=dict(embed=True)), (0.55,)),
]


@pytest.mark.parametrize("name,kw,volts", PER_LEAF, ids=[c[0] for c in PER_LEAF])
def test_per_leaf_engine_matches_reference_and_batched(models, name, kw, volts):
    cfg, params, tcfg, tparams = models
    kw = dict(kw)
    prot = kw.pop("protection", {})
    jrel, trel = _rels(platform="vc707", voltage=1.0, mode="inline",
                       fault_model=dict(batched=False), protection=prot, **kw)
    _, brel = _rels(platform="vc707", voltage=1.0, mode="inline", protection=prot, **kw)
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=32)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=32, device="cpu")
    b = teng.ServingEngine(tcfg, tparams, rel=brel, max_len=32, device="cpu")
    for v in (1.0,) + volts:
        for e in (j, t, b):
            e.set_voltage(v)
        _same_params(t.params, j.params)
        _same_params(b.params, t.params)
        assert _stats(t._last_scrub) == _stats(j._last_scrub) == _stats(b._last_scrub)
        tok = t.generate(PROMPTS, N_NEW)
        np.testing.assert_array_equal(tok, j.generate(PROMPTS, N_NEW))
        np.testing.assert_array_equal(tok, b.generate(PROMPTS, N_NEW))
    assert t._last_scrub.faulty_words > 0
    assert _stats(t.stats) == _stats(j.stats) == _stats(b.stats)
    assert t.power_report() == j.power_report()


def test_per_leaf_autotune_matches_reference(models):
    cfg, params, tcfg, tparams = models
    jrel, trel = _rels(platform="vc707", voltage=0.62, mode="inline",
                       fault_model=dict(batched=False), rails=dict(start_v=0.62))
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=32)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=32, device="cpu")
    jl, jh = j.autotune_voltage()
    tl, th = t.autotune_voltage()
    rec = lambda h: [(r.voltage, r.detected, r.action) for r in h]
    assert tl == jl and rec(th) == rec(jh)


# -- domain mode ------------------------------------------------------------------
@pytest.fixture(scope="module", params=[True, False], ids=["ecc", "no_ecc"])
def domain_engines(request, models):
    cfg, params, tcfg, tparams = models
    jrel, trel = _rels(platform="vc707", voltage=1.0, mode="domain", ecc=request.param,
                       rails=dict(start_v=0.62))
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=32)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=32, device="cpu")
    return j, t


def test_domain_mode_nominal_is_the_unprotected_model(models, domain_engines):
    _, _, tcfg, tparams = models
    j, t = domain_engines
    for e in (j, t):
        e.set_voltage(1.0)
    _same_params(t.params, tparams)
    plain = teng.ServingEngine(tcfg, tparams, rel=None, max_len=32, device="cpu")
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), plain.generate(PROMPTS, N_NEW))


@pytest.mark.parametrize("v", [1.0, 0.56, 0.54])
def test_domain_mode_matches_reference(domain_engines, v):
    j, t = domain_engines
    j.set_voltage(v)
    t.set_voltage(v)
    _same_params(t.params, j.params)
    assert _stats(t.stats) == _stats(j.stats)
    assert _stats(t.domain.stats) == _stats(j.domain.stats)
    if v < 0.6:
        assert t.stats.faulty_words > 0
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))
    assert t.power_w() == j.power_w() and t.power_report() == j.power_report()


def test_domain_mode_autotune_matches_reference(domain_engines):
    j, t = domain_engines
    for e in (j, t):
        e.set_voltage(e.controller.voltage)
    jl, jh = j.autotune_voltage()
    tl, th = t.autotune_voltage()
    rec = lambda h: [(r.voltage, r.corrected, r.detected, r.action) for r in h]
    assert tl == jl and rec(th) == rec(jh)
    _same_params(t.params, j.params)
    assert _stats(t.stats) == _stats(j.stats)


@pytest.mark.parametrize("v", [1.0, 0.56])
def test_domain_mode_serve_matches_reference(models, monkeypatch, v):
    """``serve`` on a domain-mode engine runs on the read-back params at
    ``v``, its KV pages at 0.55 V with the same numpy masks in both
    packages (``test_torch_serve.Masks``)."""
    cfg, params, tcfg, tparams = models
    jrel, trel = _rels(platform="vc707", voltage=v, mode="domain")
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=32)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=32, device="cpu")
    masks = Masks(seed=3, scale=6.0).install(monkeypatch)
    kw = dict(n_lanes=3, page_tokens=PT, kv_voltage=0.55)
    jr = j.serve(MIXED, **kw)
    tr = t.serve(MIXED, **kw)
    _assert_reports_equal(jr, tr)
    assert masks.calls > 0 and tr.kv_stats.corrected > 0
    assert _stats(t.stats) == _stats(j.stats)
    assert t.power_report() == j.power_report()


def test_default_config_is_domain_mode_and_valid():
    rel = teng.ReliabilityConfig()
    assert rel.mode == "domain" and rel.validate() is rel


# -- validate() ------------------------------------------------------------------
def _accepts(rel) -> bool:
    try:
        rel.validate()
    except ValueError:
        return False
    return True


GRID = list(itertools.product(
    ("domain", "inline", "paged"), (True, False), (False, True),
    (None, "secded72", {"attention": "secded72"}),
))


@pytest.mark.parametrize("mode,batched,multi,codecs", GRID)
def test_validate_matches_reference(models, mode, batched, multi, codecs):
    jrel, trel = _rels(mode=mode, fault_model=dict(batched=batched),
                       rails=dict(multi_rail=multi), protection=dict(codecs=codecs))
    if mode == "domain" and multi and codecs in (None, "secded72"):
        # The reference's validate() lets this through and its engine then
        # fails to build (domain mode has no plane arena for the rails); the
        # port refuses it in validate().
        assert not _accepts(trel) and _accepts(jrel)
        cfg, params, _, _ = models
        with pytest.raises(AttributeError):
            jeng.ServingEngine(cfg, params, rel=jrel, max_len=32)
        return
    assert _accepts(trel) == _accepts(jrel)
