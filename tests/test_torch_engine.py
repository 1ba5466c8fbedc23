"""Port parity at the slice's end: the inline-SECDED serving engine on the
tiny config, single-rail and multi-rail, against the reference engine."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from conftest import tiny_cfg
from repro.models import lm as jlm
from repro.serving.engine import ProtectionConfig as JProt
from repro.serving.engine import ReliabilityConfig as JRel
from repro.serving.engine import RailsConfig as JRails
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.core import controller as tctl
from repro_torch.models import base as tbase
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as teng

# float32 logits: the port's matmuls sum in another order than the
# reference's Pallas kernel
LOGIT_RTOL = 1e-4
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


def _record(r) -> dict:
    """A controller record by the port's fields (the reference's records
    also carry mesh-shard and accuracy-canary fields the port has not yet)."""
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(tctl.ControllerRecord)}


def _drive(eng, multi):
    """Nominal tokens, 0.56 V tokens + counters, autotune, power report."""
    out = {"nominal": eng.generate(PROMPTS, N_NEW)}
    eng.set_voltage(0.56)
    out["tok_056"] = eng.generate(PROMPTS, N_NEW)
    scrub = eng._last_scrub
    out["scrub_056"] = (
        {d: dataclasses.asdict(s) for d, s in scrub.by_domain.items()}
        if multi else dataclasses.asdict(scrub)
    )
    if not multi:
        eng.set_voltage(eng.controller.voltage)
    lock, hist = eng.autotune_voltage()
    out["lock"] = lock
    out["history"] = (
        {d: [_record(r) for r in h] for d, h in hist.items()}
        if multi else [_record(r) for r in hist]
    )
    out["tok_lock"] = eng.generate(PROMPTS, N_NEW)
    out["power"] = eng.power_report()
    out["stats"] = dataclasses.asdict(eng.stats)
    return out


CODEC_MIX = {"attention": "parity65", "mlp": "dected79", "kv": "ileave88"}
# (multi_rail, codecs): the SECDED engines, then the codec engines
ENGINES = [(False, None), (True, None), (False, "dected79"), (True, CODEC_MIX)]


def _engines(models, multi, codecs, **kw):
    cfg, params, tcfg, tparams = models
    kw = dict(dict(platform="vc707", voltage=1.0, mode="inline"), **kw)
    jrel = JRel(**kw, rails=JRails(multi_rail=multi, start_v=0.62),
                protection=JProt(codecs=codecs))
    trel = teng.ReliabilityConfig(**kw, rails=teng.RailsConfig(multi_rail=multi, start_v=0.62),
                                  protection=teng.ProtectionConfig(codecs=codecs))
    return (JEngine(cfg, params, rel=jrel, max_len=32),
            teng.ServingEngine(tcfg, tparams, rel=trel, max_len=32, device="cpu"))


@pytest.fixture(scope="module", params=ENGINES,
                ids=["single_rail", "multi_rail", "single_rail_dected79", "multi_rail_codecs"])
def runs(request, models):
    multi, codecs = request.param
    jeng, teng_ = _engines(models, multi, codecs)
    return _drive(jeng, multi), _drive(teng_, multi)


@pytest.mark.parametrize("what", ["nominal", "tok_056", "tok_lock"])
def test_greedy_tokens_equal(runs, what):
    j, t = runs
    np.testing.assert_array_equal(t[what], j[what])


def test_counters_equal(runs):
    j, t = runs
    assert t["scrub_056"] == j["scrub_056"]
    assert t["stats"] == j["stats"]


def test_autotune_lock_and_history_equal(runs):
    j, t = runs
    assert t["lock"] == j["lock"]
    assert t["history"] == j["history"]


def test_power_report_equal(runs):
    j, t = runs
    assert t["power"] == j["power"]


@pytest.mark.parametrize("multi", [False, True])
def test_prefill_logits_within_tolerance(models, multi):
    cfg, params, tcfg, tparams = models
    rel = dict(platform="vc707", voltage=0.56, mode="inline")
    jeng = JEngine(cfg, params, rel=JRel(**rel, rails=JRails(multi_rail=multi)), max_len=32)
    trel = teng.ReliabilityConfig(**rel, rails=teng.RailsConfig(multi_rail=multi))
    teng_ = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=32, device="cpu")
    jl, _ = jlm.prefill(jeng.params, jax.numpy.asarray(PROMPTS), cfg,
                        jlm.init_cache(cfg, 2, 32))
    tl, _ = tlm.prefill(teng_.params, torch.from_numpy(PROMPTS).long(), tcfg,
                        tlm.init_cache(tcfg, 2, 32, device="cpu"))
    jl = np.asarray(jl)
    assert tl.shape == jl.shape
    assert np.abs(tl.numpy() - jl).max() <= LOGIT_RTOL * np.abs(jl).max()


def test_params_from_numpy_keeps_tree_and_keys(models):
    _, params, _, tparams = models
    jkeys = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [k for k, _ in tbase.flatten(tparams)] == jkeys


def test_entry_points_default_to_the_card(models, monkeypatch):
    _, _, tcfg, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rel = teng.ReliabilityConfig(mode="inline")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.ServingEngine(tcfg, tparams, rel=rel)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_params(tcfg)


@pytest.mark.parametrize("kw", [
    # domain mode and the per-leaf path are ported; with several rails
    # neither is valid
    {"mode": "domain", "rails": teng.RailsConfig(multi_rail=True)},
    {"fault_model": teng.FaultModelConfig(batched=False), "rails": teng.RailsConfig(multi_rail=True)},
    # codecs are ported on the batched inline arena; domain mode stays SECDED
    {"mode": "domain", "protection": teng.ProtectionConfig(codecs="dected79")},
    {"protection": teng.ProtectionConfig(codecs={"attention": "secded72"})},
    {"fault_model": teng.FaultModelConfig(environment="mars")},
    # the accuracy canary diffs the inline arena's clean templates
    {"mode": "domain", "canary": teng.CanaryConfig(prompts=2)},
    {"platform": "nope"},
    {"fault_model": teng.FaultModelConfig(batched=False),
     "protection": teng.ProtectionConfig(codecs="ileave88")},
    {"protection": teng.ProtectionConfig(codecs="hamming71")},
])
def test_validate_rejects_unported(kw):
    with pytest.raises(teng.ReliabilityConfigError):
        teng.ReliabilityConfig(**{"mode": "inline", **kw}).validate()


@pytest.mark.parametrize("multi,codecs,ladder", [
    (True, None, ("secded72", "dected79")),
    (True, {"mlp": "dected79"}, ("dected79",)),
    (False, None, ("secded72", "ileave88", "dected79")),  # a single rail ignores it
])
def test_validate_accepts_escalation_as_the_reference_does(multi, codecs, ladder):
    jrel = JRel(mode="inline", rails=JRails(multi_rail=multi),
                protection=JProt(codecs=codecs, escalation=ladder))
    rel = teng.ReliabilityConfig(mode="inline", rails=teng.RailsConfig(multi_rail=multi),
                                 protection=teng.ProtectionConfig(codecs=codecs,
                                                                  escalation=ladder))
    assert jrel.validate() is jrel and rel.validate() is rel
    assert rel.escalation_policy.ladder == jrel.escalation_policy.ladder == ladder


def test_validate_rejects_a_mesh():
    rel = teng.ReliabilityConfig(mode="inline")
    assert rel.validate() is rel
    with pytest.raises(teng.ReliabilityConfigError, match="mesh"):
        rel.validate(mesh=object())


@pytest.mark.parametrize("multi,embed,protected", [
    (False, None, False), (True, None, True), (True, False, False), (False, True, True),
])
def test_config_groups_set_embed_protection(multi, embed, protected):
    rel = teng.ReliabilityConfig(
        mode="inline", rails=teng.RailsConfig(multi_rail=multi, start_v=0.6),
        protection=teng.ProtectionConfig(embed=embed),
    )
    assert rel.validate().embed_protected is protected
    assert dataclasses.replace(rel, seed=3).rails == rel.rails
    with pytest.raises(TypeError):  # one spelling: the grouped fields only
        teng.ReliabilityConfig(mode="inline", multi_rail=multi)


@pytest.mark.parametrize("kw", [
    {"protection": teng.ProtectionConfig(codecs="dected79")},
    {"protection": teng.ProtectionConfig(codecs="parity65")},
    {"rails": teng.RailsConfig(multi_rail=True), "protection": teng.ProtectionConfig(codecs=CODEC_MIX)},
    {"rails": teng.RailsConfig(multi_rail=True), "protection": teng.ProtectionConfig(codecs="ileave88")},
])
def test_validate_accepts_codecs_on_the_inline_arena(kw):
    """As the reference's validate: any registered codec on the batched
    inline arena, a {domain: name} dict with several rails."""
    rel = teng.ReliabilityConfig(mode="inline", **kw)
    assert rel.validate() is rel
    rails = JRails(multi_rail=kw.get("rails", teng.RailsConfig()).multi_rail)
    JRel(mode="inline", rails=rails, protection=JProt(codecs=kw["protection"].codecs)).validate()


def _dequantised(leaf) -> np.ndarray:
    """The float (K, N) or (G, K, N) table of an EccWeight's int8 words."""
    from repro_torch.kernels import ref as tref

    if leaf.lo.ndim == 2:
        return (tref.unpack_ecc_weights(leaf.lo, leaf.hi).to(torch.float32) * leaf.scale).numpy()
    return np.stack([_dequantised(leaf.layer(g)) for g in range(leaf.lo.shape[0])])


@pytest.mark.parametrize("multi,codecs", ENGINES[2:], ids=["single_rail_dected79",
                                                          "multi_rail_codecs"])
def test_refreshed_codec_leaves_dequantise_to_the_reference_tables(models, multi, codecs):
    """A leaf under a codec other than SECDED, after a 0.54 V step: its
    refreshed SECDED planes decode with syndrome 0 to int8 words whose
    dequantised values are exactly the reference's decoded float table
    (``_decode_gather_table``); SECDED leaves stay planes in both."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops

    jeng, teng_ = _engines(models, multi, codecs, voltage=0.54)
    jflat = {jax.tree_util.keystr(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(
        jeng.params, is_leaf=lambda x: isinstance(x, jops.EccWeight))[0]}
    refreshed = 0
    for key, leaf in tbase.flatten(teng_.params):
        if not isinstance(leaf, tops.EccWeight):
            continue
        if teng_._leaf_codec(key) == "secded72":
            assert isinstance(jflat[key], jops.EccWeight)
            continue
        assert not tops.decode(leaf.lo, leaf.hi, leaf.parity)[2].any()  # syndromes all 0
        np.testing.assert_array_equal(_dequantised(leaf), np.asarray(jflat[key]))
        refreshed += 1
    # every protected attention and MLP leaf is under a codec other than SECDED
    assert refreshed == sum(isinstance(w, tops.EccWeight) and "embed" not in k
                            for k, w in tbase.flatten(teng_.params)) > 0
