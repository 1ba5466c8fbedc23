"""Port parity of the accuracy campaign and the accuracy canary: the
divergence scorers, the eval set and voltage grid, the controllers'
divergence SLO (records and events), a tiny campaign on the reference's
weights and the engine's canary with its blind-counter retreat, against the
reference on the CPU."""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.core import campaign as jcamp
from repro.core import controller as jctl
from repro.core.sweep import campaign_voltage_grid as j_grid
from repro.core.telemetry import FaultStats as JStats
from repro.models import lm as jlm
from repro.obs import TraceRecorder as JRecorder
from repro.serving import engine as jeng
from repro_torch.core import campaign as tcamp
from repro_torch.core import controller as tctl
from repro_torch.core import sweep as tsweep
from repro_torch.core.telemetry import FaultStats
from repro_torch.core.voltage import PLATFORMS
from repro_torch.models import base as tbase
from repro_torch.obs import TraceRecorder
from repro_torch.serving import engine as teng
from test_torch_qwen2 import biased

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VC707 = PLATFORMS["vc707"]
COUNTERS = ("words", "clean", "corrected", "detected", "silent", "words_1bit",
            "words_2bit", "words_multi", "faulty_bits", "faulty_words")


# ---------------------------------------------------------------------------
# Scorers, eval set, grid and model names
# ---------------------------------------------------------------------------
def _fixtures():
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 6, (5, 9))
    test = ref.copy()
    test[1, 4:] = (test[1, 4:] + 1) % 6  # mismatch at 4
    test[2, 0] = (test[2, 0] + 3) % 6  # at 0
    test[4, 8] = (test[4, 8] + 1) % 6  # at the last token
    logits = rng.normal(size=(5, 9, 11)) * 3.0
    faulty = logits + rng.normal(size=logits.shape) * 0.4
    return ref, test, logits, faulty


def test_scorers_equal_reference():
    ref, test, logits, faulty = _fixtures()
    for a, b in ((ref, test), (ref, ref.copy()), (ref[:, :0], test[:, :0])):
        if a.shape[1]:
            np.testing.assert_array_equal(tcamp.greedy_match_len(a, b),
                                          jcamp.greedy_match_len(a, b))
        assert tcamp.token_divergence(a, b) == jcamp.token_divergence(a, b)
    for a, b in ((ref[:, 0], test[:, 0]), (ref, test), (ref[:0], test[:0])):
        assert tcamp.label_divergence(a, b) == jcamp.label_divergence(a, b)
    assert tcamp.logit_kl(logits, faulty) == jcamp.logit_kl(logits, faulty)
    assert tcamp.logit_kl(logits, logits.copy()) == 0.0
    assert tcamp.token_nll(faulty, ref) == jcamp.token_nll(faulty, ref)
    assert tcamp.perplexity(logits, ref) == jcamp.perplexity(logits, ref)
    for args in ((ref, test), (ref, test, logits, faulty, ref), (ref, ref, logits, logits, ref)):
        assert dataclasses.asdict(tcamp.score(*args)) == dataclasses.asdict(jcamp.score(*args))
    assert tcamp.SCORER_VERSION == jcamp.SCORER_VERSION
    assert tcamp.CANARY_PROMPT_LEN == jcamp.CANARY_PROMPT_LEN
    # the reference's hand-computed fixture: KL = 0.5 ln(4/3)
    assert tcamp.logit_kl(np.zeros((1, 1, 2)), np.array([[[math.log(3.0), 0.0]]])) == \
        pytest.approx(0.5 * math.log(4.0 / 3.0), rel=1e-12)


@pytest.mark.parametrize("args", [(256, 4, 8, 3), (152064, 2, 8, 0 ^ 0xACC), (128, 0, 8, 1)])
def test_eval_prompts_equal_reference(args):
    t, j = tcamp.eval_prompts(*args), jcamp.eval_prompts(*args)
    assert t.dtype == j.dtype == np.int32
    np.testing.assert_array_equal(t, j)


def test_voltage_grids_equal_reference():
    from repro.core import sweep as jsweep
    from repro.core.voltage import PLATFORMS as JPLATFORMS

    for name, p in PLATFORMS.items():
        for step in (0.02, 0.01):
            assert tsweep.campaign_voltage_grid(p, step) == j_grid(JPLATFORMS[name], step)
    assert [(p.name, v) for p, v in tsweep.paper_grid()] == \
        [(p.name, v) for p, v in jsweep.paper_grid()]
    assert tsweep.campaign_voltage_grid(VC707) == (1.0, 0.61, 0.59, 0.57, 0.55, 0.54)
    assert tcamp.CampaignSpec(platform="kc705a").voltage_grid() == \
        jcamp.CampaignSpec(platform="kc705a").voltage_grid()


def test_campaign_model_names():
    for name in ("tiny", "qwen2-7b-smoke", "qwen3-0.6b-smoke", "qwen2-7b"):
        t, j = tcamp.campaign_model(name), jcamp.campaign_model(name)
        assert t.name == j.name
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "qkv_bias"):
            assert getattr(t, f) == getattr(j, f), (name, f)


# ---------------------------------------------------------------------------
# Controllers: the divergence SLO (the reference's cases, as parity)
# ---------------------------------------------------------------------------
def _records(ctl) -> list:
    return [{f.name: getattr(r, f.name) for f in dataclasses.fields(tctl.ControllerRecord)}
            for r in ctl.history]


def _both(make, feed):
    """Run ``feed(ctl, Stats)`` on both packages' controllers made by
    ``make(module)``, each with a recorder; returns the port's controller and
    asserts equal records and JSONL."""
    out = []
    for mod, stats, rec in ((jctl, JStats, JRecorder()), (tctl, FaultStats, TraceRecorder())):
        c = make(mod)
        c.bind_recorder(rec)
        feed(c, stats)
        rails = c.rails.values() if hasattr(c, "rails") else [c]
        out.append((c, [_records(r) for r in rails], rec.to_jsonl()))
    (_, jrec, jjs), (tc, trec, tjs) = out
    assert trec == jrec
    assert tjs == jjs
    return tc


def test_acc_trip_retreats_with_zero_ded():
    def feed(c, st):
        c.update(st(words=1000), divergence=0.0)
        c.update(st(words=1000), divergence=0.4)

    c = _both(lambda m: m.UndervoltController(VC707, start_v=VC707.v_min, divergence_slo=0.05),
              feed)
    assert c.locked and c.voltage == pytest.approx(VC707.v_min)
    assert [h.action for h in c.history] == ["lower", "acc+backoff"]
    assert c.history[-1].divergence == pytest.approx(0.4)


def test_divergence_ignored_without_slo():
    c = _both(lambda m: m.UndervoltController(VC707, start_v=0.58),
              lambda c, st: c.update(st(words=1000), divergence=0.9))
    assert not c.locked and c.history[-1].action == "lower"
    assert c.history[-1].divergence == pytest.approx(0.9)


def test_acc_trip_escalates_codec_before_retreating():
    def make(m):
        return m.UndervoltController(
            VC707, start_v=0.57, divergence_slo=0.1,
            escalation=m.EscalationPolicy(ladder=("secded72", "dected79")))

    def feed(c, st):
        c.update(st(words=1000), divergence=0.5)
        assert c.pop_codec_change() == "dected79"
        c.update(st(words=1000), divergence=0.5)

    c = _both(make, feed)
    assert [h.action for h in c.history] == ["escalate", "acc+backoff"] and c.locked


def test_ded_and_acc_trip_together_back_off_as_a_ded_trip():
    c = _both(lambda m: m.UndervoltController(VC707, start_v=0.58, divergence_slo=0.1),
              lambda c, st: c.update(st(words=1000, detected=2), divergence=0.6))
    assert c.history[-1].action == "trip+backoff"


@pytest.mark.parametrize("div", [0.5, {"mlp": 0.5}, None])
def test_multirail_broadcasts_scalar_divergence(div):
    def feed(c, st):
        c.update({"attn": st(words=100), "mlp": st(words=100)}, divergence=div)

    c = _both(lambda m: m.MultiRailController(VC707, ("attn", "mlp"), divergence_slo=0.1), feed)
    tripped = {d for d, r in c.rails.items() if r.locked}
    assert tripped == ({"attn", "mlp"} if div == 0.5 else {"mlp"} if div else set())


# ---------------------------------------------------------------------------
# A tiny campaign in both packages, on the reference's weights
# ---------------------------------------------------------------------------
SPEC = dict(codecs=("parity65", "ileave88"), voltages=(1.0, 0.55, 0.54), n_prompts=2,
            n_tokens=8, proxy_words=0)


@pytest.fixture(scope="module")
def campaign_runs():
    mp = pytest.MonkeyPatch()
    real_init = jlm.init_params

    def j_init(cfg, key):  # the reference's weights with nonzero biases
        return jax.tree_util.tree_map(jax.numpy.asarray, biased(real_init(cfg, key)))

    def t_params(cfg, seed, device):
        jcfg = jcamp.campaign_model("tiny")
        return tbase.params_from_numpy(biased(real_init(jcfg, jax.random.PRNGKey(seed))),
                                       cfg, device=device)

    mp.setattr(jlm, "init_params", j_init)
    mp.setattr(tcamp, "campaign_params", t_params)
    try:
        jrec, trec = JRecorder(), TraceRecorder()
        rows = {
            "ref": jcamp.run_campaign(jcamp.CampaignSpec(**SPEC), recorder=jrec),
            "port": tcamp.run_campaign(tcamp.CampaignSpec(**SPEC), recorder=trec,
                                       device="cpu"),
        }
    finally:
        mp.undo()
    return rows, jrec.to_jsonl(), trec.to_jsonl()


def test_campaign_rows_equal_reference(campaign_runs):
    rows, _, _ = campaign_runs
    assert len(rows["port"]) == len(rows["ref"]) == 6
    for t, j in zip(rows["port"], rows["ref"]):
        assert set(t) == set(j)
        for k in ("model", "arch", "platform", "codec", "environment", "voltage", "nominal",
                  "n_prompts", "n_tokens", "divergence", "match_len", "match_frac",
                  "scorer_version", "bram_saving_vs_nominal", "seed") + COUNTERS:
            assert t[k] == j[k], (t["codec"], t["voltage"], k, t[k], j[k])
        for k in ("kl", "ppl_clean", "ppl_faulty", "ppl_delta"):
            assert t[k] == pytest.approx(j[k], rel=1e-3, abs=1e-6), (t["codec"], t["voltage"], k)


def test_campaign_shape(campaign_runs):
    rows, _, _ = campaign_runs
    at = {(r["codec"], r["voltage"]): r for r in rows["port"]}
    for codec in SPEC["codecs"]:
        nominal = at[(codec, 1.0)]
        assert nominal["divergence"] == 0.0 and nominal["kl"] == 0.0
        assert nominal["ppl_delta"] == 0.0 and nominal["faulty_words"] == 0
        assert 0 < at[(codec, 0.55)]["faulty_words"] < at[(codec, 0.54)]["faulty_words"]
    # the 4-way interleaved code never diverges more than the detect-only
    # code and still matches the clean rollout where that one has diverged
    # (with these biases, at 0.54 V; the reference's own test shows it at
    # 0.55 V on its zero-bias weights)
    for v in SPEC["voltages"]:
        assert at[("ileave88", v)]["divergence"] <= at[("parity65", v)]["divergence"]
    assert at[("ileave88", 0.55)]["divergence"] == at[("ileave88", 0.54)]["divergence"] == 0.0
    assert at[("parity65", 0.54)]["divergence"] > 0.0
    assert at[("parity65", 0.55)]["detected"] > at[("ileave88", 0.55)]["detected"] == 0


def test_campaign_events_equal_reference(campaign_runs):
    _, jjs, tjs = campaign_runs
    assert tjs == jjs and tjs.count("campaign_point") == 6


def test_campaign_proxy_columns_come_from_the_codec_sweep():
    """The proxy columns come from ``sweep_codec_schemes`` at the same point
    (the device field: equal to the reference in distribution only)."""
    spec = tcamp.CampaignSpec(codecs=("secded72",), voltages=(0.54,), n_prompts=1,
                              n_tokens=2, proxy_words=4096)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        (row,) = tcamp.run_campaign(spec, device="cpu")
        (want,) = tsweep.sweep_codec_schemes(["secded72"], [(VC707, 0.54)], 4096, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert row["proxy_words"] == 4096 and row["proxy_faulty_words"] == want["faulty_words"] > 0
    for k in ("corrected", "detected", "silent"):
        assert row[f"proxy_{k}"] == want[k]


# ---------------------------------------------------------------------------
# The accuracy canary in the engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_setup():
    cfg = jcamp.campaign_model("tiny")
    tree = biased(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    tcfg = tcamp.campaign_model("tiny")
    return cfg, params, tcfg, tbase.params_from_numpy(tree, tcfg, device="cpu")


def _engines(setup, multi=False, canary=None, **kw):
    cfg, params, tcfg, tparams = setup
    rails = dict(multi_rail=multi, start_v=VC707.v_min)
    jrel = jeng.ReliabilityConfig(platform="vc707", mode="inline", **kw,
                                  rails=jeng.RailsConfig(**rails),
                                  canary=jeng.CanaryConfig(**(canary or {})))
    trel = teng.ReliabilityConfig(platform="vc707", mode="inline", **kw,
                                  rails=teng.RailsConfig(**rails),
                                  canary=teng.CanaryConfig(**(canary or {})))
    return (jeng.ServingEngine(cfg, params, rel=jrel, max_len=32),
            teng.ServingEngine(tcfg, tparams, rel=trel, max_len=32, device="cpu"))


def test_canary_divergence_disabled_and_clean(tiny_setup):
    j, t = _engines(tiny_setup)
    assert t.canary_divergence() is None and j.canary_divergence() is None
    rec = TraceRecorder()
    j, t = _engines(tiny_setup, canary=dict(prompts=2, tokens=8))
    t.recorder = rec
    assert t.canary_divergence() == j.canary_divergence() == 0.0
    np.testing.assert_array_equal(t._canary_ref, j._canary_ref)
    assert [e["divergence"] for e in rec.of_kind("canary_probe")] == [0.0]


def _histories(eng):
    hist = eng.controller.history
    return ({d: [_records_of(h) for h in hs] for d, hs in hist.items()}
            if isinstance(hist, dict) else [_records_of(h) for h in hist])


def _records_of(r) -> dict:
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(tctl.ControllerRecord)}


@pytest.fixture(scope="module")
def blind_walks(tiny_setup):
    """The reference's acceptance scenario: ecc=False re-encodes the check
    bits over the faulty planes, so DED never fires; the control walk goes
    to the crash floor, the canary walk retreats on divergence alone."""
    out = {}
    for name, canary in (("control", None),
                         ("canary", dict(prompts=2, tokens=8, divergence_slo=0.05))):
        j, t = _engines(tiny_setup, canary=canary, ecc=False)
        out[name] = (j.autotune_voltage(max_rounds=12), t.autotune_voltage(max_rounds=12), j, t)
    return out


@pytest.mark.parametrize("name", ["control", "canary"])
def test_blind_walk_histories_equal_reference(blind_walks, name):
    (jv, _), (tv, _), j, t = blind_walks[name]
    assert tv == jv
    assert _histories(t) == _histories(j)


def test_canary_retreats_where_ded_counters_are_blind(blind_walks):
    (v_ctl, hist_ctl), _, _ = blind_walks["control"][1:]
    assert all(h.detected == 0 for h in hist_ctl) and hist_ctl[-1].action == "floor"
    (v, hist), t = blind_walks["canary"][1], blind_walks["canary"][3]
    assert all(h.detected == 0 for h in hist)
    assert any(h.action == "acc+backoff" for h in hist) and t.controller.locked
    assert v > v_ctl + 1e-9 and hist[-1].divergence > 0.05


def test_canary_multirail_retreats_all_rails(tiny_setup):
    j, t = _engines(tiny_setup, multi=True, ecc=False,
                    canary=dict(prompts=2, tokens=8, divergence_slo=0.05))
    assert t.autotune_voltage(max_rounds=12)[0] == j.autotune_voltage(max_rounds=12)[0]
    assert _histories(t) == _histories(j)
    tripped = {d for d, c in t.controller.rails.items()
               if any(h.action == "acc+backoff" for h in c.history)}
    assert tripped == set(t._store.domains)


def test_validate_takes_the_canary_inline_only():
    teng.ReliabilityConfig(mode="inline", canary=teng.CanaryConfig(prompts=2)).validate()
    with pytest.raises(teng.ReliabilityConfigError):
        teng.ReliabilityConfig(mode="domain", canary=teng.CanaryConfig(prompts=2)).validate()


def test_new_modules_import_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}]\n"
        "import repro_torch.core.campaign, repro_torch.core.sweep, repro_torch.configs.qwen2_7b\n"
        "import repro_torch.core as c\n"
        "assert c.run_campaign and c.CampaignSpec and c.DivergenceReport and c.sweep\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')"
        " and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_need_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcamp.run_campaign(tcamp.CampaignSpec(**SPEC))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsweep.sweep_platform_grid([(VC707, 0.55)], 64)
