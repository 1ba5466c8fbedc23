"""Port parity of the hybrid family (``models/mamba.py``; jamba-1.5-large-
398b) and of ``moe_every > 1`` against the reference on smoke configs: the
causal convolution, the chunked selective scan and the mamba layer (fresh
and stateful, several lengths), jamba's config and p0..p7 parameter tree,
prefill / decode logits, greedy tokens and the cache, the inline engine's
protected keys, counters and tokens at 0.56 V under host masks, and
mixtral's smoke config with an MoE layer at every second position."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.serving import engine as jeng
from repro_torch import configs as tconfigs
from repro_torch.models import base as tbase
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba
from repro_torch.serving import engine as teng
from test_torch_engine_modes import _rels, _same_params, _stats
from test_torch_rwkv6 import (  # noqa: F401
    FIELDS, LOGIT_RTOL, MAX_LEN, N_NEW, PROMPTS, S0, _cache_close, _close, _one_torch_thread, _t,
    pair, seeded,
)

ARCH = "jamba-1.5-large-398b"
LENGTHS = (1, 2, 64, 128)


@pytest.fixture(scope="module")
def models():
    cfg, tcfg = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    params = seeded(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, params, tcfg, pair(params, tcfg)


# -- configs and parameters ---------------------------------------------------------
@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_and_param_tree_match_reference(get):
    j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    for f in FIELDS + ("top_k", "capacity_factor", "shared_expert"):
        assert getattr(t, f) == getattr(j, f), (get, f)
    for f in ("param_dtype", "compute_dtype"):
        assert str(getattr(t, f)).split(".")[-1] == np.dtype(getattr(j, f)).name, f
    assert t.period == j.period == 8 and t.n_groups == j.n_groups and t.d_inner == j.d_inner
    assert [t.layer_kind(i) for i in range(8)] == [j.layer_kind(i) for i in range(8)]
    assert [t.layer_kind(i)["mixer"] for i in range(8)] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    specs = tbase.flatten(tlm.init_specs(t), is_leaf=lambda x: isinstance(x, tbase.Spec))
    jstruct = jax.tree_util.tree_flatten_with_path(jlm.param_struct(j))[0]
    assert [k for k, _ in specs] == [jax.tree_util.keystr(k) for k, _ in jstruct]
    assert [s.shape for _, s in specs] == [s.shape for _, s in jstruct]
    assert sum(int(np.prod(s.shape)) for _, s in specs) == jlm.param_count(j)[0]
    assert sorted(tlm.init_specs(t)["blocks"]) == [f"p{i}" for i in range(8)]


def test_one_jamba_period_does_not_fit_one_card():
    """One 8-layer period of the published width plus the embedding and
    head holds ~45 G parameters (~90.5 GB in bf16): the whole model waits
    for multi-device work, and the card runs the smoke config and one mamba
    layer at the published width."""
    c = dataclasses.replace(tconfigs.get_config(ARCH), n_layers=8)
    specs = tbase.flatten(tlm.init_specs(c), is_leaf=lambda x: isinstance(x, tbase.Spec))
    gb = 2 * sum(int(np.prod(s.shape)) for _, s in specs) / 1e9
    assert 90.0 < gb < 91.0, gb


# -- the layer ---------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 2, 5, 64])
def test_conv_causal_matches_reference(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    w = rng.standard_normal((32, 4)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    _close(tmamba._conv_causal(*map(torch.from_numpy, (x, w, b))),
           jmamba._conv_causal(*map(jnp.asarray, (x, w, b))))


@pytest.mark.parametrize("nonzero", [False, True], ids=["zero_state", "state"])
@pytest.mark.parametrize("s", LENGTHS + (192,))
def test_ssm_scan_chunked_matches_reference(s, nonzero):
    rng = np.random.default_rng(s)
    b, di, ds = 2, 32, 8
    decay = np.exp(-np.abs(rng.standard_normal((b, s, di, ds))) * 0.3).astype(np.float32)
    inp = rng.standard_normal((b, s, di, ds)).astype(np.float32) * 0.3
    cc = rng.standard_normal((b, s, ds)).astype(np.float32)
    h0 = (rng.standard_normal((b, di, ds)) if nonzero else np.zeros((b, di, ds))).astype(
        np.float32)
    jy, jh = jmamba._ssm_scan_chunked(*map(jnp.asarray, (decay, inp, cc, h0)))
    ty, th = tmamba._ssm_scan_chunked(*map(torch.from_numpy, (decay, inp, cc, h0)))
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("stateful", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("s", LENGTHS)
def test_mamba_layer_matches_reference(models, s, stateful):
    cfg, params, tcfg, _ = models
    p = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["p0"]["mamba"])
    rng = np.random.default_rng(s + 10 * stateful)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    st = None
    if stateful:
        st = {"conv": rng.standard_normal((2, cfg.d_conv - 1, cfg.d_inner)).astype(np.float32),
              "ssm": rng.standard_normal((2, cfg.d_inner, cfg.d_state)).astype(np.float32)}
    jo, jst = jmamba.mamba_layer(jnp.asarray(x), p, cfg,
                                 None if st is None else jax.tree_util.tree_map(jnp.asarray, st))
    to, tst = tmamba.mamba_layer(torch.from_numpy(x), _t(p), tcfg, None if st is None else _t(st))
    _close(to, jo)
    for k in ("conv", "ssm"):
        assert tuple(tst[k].shape) == jst[k].shape
        _close(tst[k], jst[k])


# -- the model ---------------------------------------------------------------------
def test_jamba_prefill_decode_tokens_and_cache_match_reference(models):
    cfg, params, tcfg, tparams = models
    jc0 = jlm.init_cache(cfg, 2, MAX_LEN)
    tc = tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    assert {p: {k: tuple(v.shape) for k, v in c.items()} for p, c in tc.items()} == {
        p: {k: v.shape for k, v in c.items()} for p, c in jc0.items()}
    jl, jc = jlm.prefill(params, jnp.asarray(PROMPTS), cfg, jc0)
    tl, tc = tlm.prefill(tparams, torch.from_numpy(PROMPTS).long(), tcfg, tc)
    _close(tl, jl)
    _cache_close(tc, jc)
    jtok, ttok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32), torch.argmax(tl, -1)[:, None]
    for i in range(3):  # each reference step compiles its scan anew
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jlm.decode_step(params, jtok, cfg, jc, S0 + i)
        tl, tc = tlm.decode_step(tparams, ttok, tcfg, tc, S0 + i)
        _close(tl, jl)
        jtok, ttok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32), torch.argmax(tl, -1)[:, None]
    _cache_close(tc, jc)
    seq = np.concatenate([PROMPTS, np.asarray(jtok)], axis=1)
    _close(tlm.sequence_logits(tparams, torch.from_numpy(seq).long(), tcfg),
           jlm.sequence_logits(params, jnp.asarray(seq), cfg))


def test_jamba_greedy_tokens_match_reference(models):
    cfg, params, tcfg, tparams = models
    j = jeng.ServingEngine(cfg, params, rel=None, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=None, max_len=MAX_LEN, device="cpu")
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))


def test_jamba_refuses_chunks_and_serve(models):
    _, _, tcfg, tparams = models
    c = tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="recurrent"):
        tlm.chunk_step(tparams, torch.from_numpy(PROMPTS).long(), tcfg, c, 0)
    t = teng.ServingEngine(tcfg, tparams, rel=None, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="paged KV unsupported"):
        t.serve([(PROMPTS[0], 3)], n_lanes=1)


def test_jamba_inline_engine_matches_reference(models):
    """14 protected leaves: p4's attention wq / wo (wk, wv are narrower
    than 64 at smoke size) and the dense MLPs of p0, p2, p4, p6; the mamba
    and MoE leaves stay plain under the reference's key rule."""
    cfg, params, tcfg, tparams = models
    _, jsizes = jeng.protect_params_inline(params, cfg)
    _, tsizes = teng.protect_params_inline(tparams, tcfg)
    assert tsizes == jsizes and len(tsizes) == 14
    assert sorted({re.findall(r"\['(p\d)'\]", k)[0] for k in tsizes}) == ["p0", "p2", "p4", "p6"]
    jrel, trel = _rels(platform="vc707", voltage=1.0, mode="inline", rails=dict(start_v=0.62))
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    j.set_voltage(0.56)
    t.set_voltage(0.56)
    _same_params(t.params, j.params)
    assert _stats(t._last_scrub) == _stats(j._last_scrub) and t._last_scrub.faulty_words > 0
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))
    for e in (j, t):
        e.set_voltage(e.controller.voltage)
    jl, jh = j.autotune_voltage()
    tl, th = t.autotune_voltage()
    rec = lambda h: [(r.voltage, r.corrected, r.detected, r.action) for r in h]
    assert tl == jl and rec(th) == rec(jh)
    assert _stats(t.stats) == _stats(j.stats) and t.power_report() == j.power_report()


# -- moe_every > 1 -------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_every_two_matches_reference(arch):
    """An MoE feed-forward at p1 and a dense MLP at p0: the tree, prefill,
    decode steps and greedy tokens."""
    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch), moe_every=2)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), moe_every=2)
    assert tcfg.period == cfg.period == 2
    assert [tcfg.layer_kind(i)["ffn"] for i in range(2)] == ["mlp", "moe"]
    params = seeded(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    tparams = pair(params, tcfg)
    assert sorted(tparams["blocks"]["p0"]) == ["attn", "ln1", "ln2", "mlp"]
    assert sorted(tparams["blocks"]["p1"]) == ["attn", "ln1", "ln2", "moe"]
    jl, jc = jlm.prefill(params, jnp.asarray(PROMPTS), cfg, jlm.init_cache(cfg, 2, MAX_LEN))
    tc = tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    tl, tc = tlm.prefill(tparams, torch.from_numpy(PROMPTS).long(), tcfg, tc)
    _close(tl, jl)
    jtok, ttok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32), torch.argmax(tl, -1)[:, None]
    for i in range(3):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jlm.decode_step(params, jtok, cfg, jc, S0 + i)
        tl, tc = tlm.decode_step(tparams, ttok, tcfg, tc, S0 + i)
        _close(tl, jl)
        jtok, ttok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32), torch.argmax(tl, -1)[:, None]
    j = jeng.ServingEngine(cfg, params, rel=None, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=None, max_len=MAX_LEN, device="cpu")
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))
