"""Port parity of the vlm family (llama-3.2-vision-11b: four self-attention
layers and a gated cross-attention layer over the image tokens a period)
against the reference on its smoke config at two periods: the config and
parameter tree, ``lm.param_count`` for every registered arch, prefill
(image K/V into the cross cache) and decode logits, caches and greedy tokens
through ``lm`` and through ``make_prefill_step`` / ``make_serve_step``,
``sequence_logits(img=)``, the cross attention's batch invariance and its
zero gates, the inline single-rail and domain-mode engines at 0.56 V under
host masks, and each input where the reference fails (a protected cross
K/V projection, ``generate``, a prefill without an image, chunks, paged
serving), which the port refuses with ``ValueError``. Every parity test
runs with the cross gates seeded nonzero: ``init_params`` draws them as
zeros, which makes every cross layer the identity."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serving import engine as jeng
from repro.serving import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as tops
from repro_torch.models import base as tbase
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as teng
from repro_torch.serving import steps as tsteps
from test_torch_engine_modes import _rels, _same_params, _stats

# float32 logits: the two packages sum in other orders
LOGIT_RTOL = 1e-4
ARCH = "llama-3.2-vision-11b"
N_LAYERS = 10  # two groups of the five-layer period
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
          "head_dim", "norm_type", "gated_mlp", "tie_embeddings", "rope_theta",
          "cross_attn_every", "n_img_tokens", "n_codebooks", "qk_norm", "qkv_bias")
B, S0, N_NEW, MAX_LEN = 2, 8, 5, 24
_rng = np.random.default_rng(0)
PROMPTS = _rng.integers(0, 256, (B, S0)).astype(np.int32)
IMG = _rng.standard_normal((B, 8, 64)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain codecs and fields are many small int64 torch ops: under
    pytest-xdist, workers that each run a thread per core contend for the
    cores; one intra-op thread a worker avoids that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gated(params, seed=1):
    """The reference's parameters with the cross gates (drawn as zeros)
    filled with seeded values, tanh(gate) within about +-0.7."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        if re.search(r"gate_(attn|ffn)", jax.tree_util.keystr(path)):
            return jnp.asarray(rng.uniform(-0.9, 0.9, np.shape(a)).astype(np.float32))
        return a

    return jax.tree_util.tree_map_with_path(fill, params)


def pair(params, tcfg):
    return tbase.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                   device="cpu")


def configs(**kw):
    kw = {"n_layers": N_LAYERS, **kw}
    return (dataclasses.replace(jconfigs.get_smoke_config(ARCH), **kw),
            dataclasses.replace(tconfigs.get_smoke_config(ARCH), **kw))


@pytest.fixture(scope="module")
def models():
    cfg, tcfg = configs()
    params = gated(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, params, tcfg, pair(params, tcfg)


def close(t, j, rtol=LOGIT_RTOL):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0,
                               atol=rtol * max(np.abs(j).max(), 1e-30))


def cache_close(tc, jc):
    for k, v in tbase.flatten(tc):
        j = jc
        for part in re.findall(r"\['([^']*)'\]", k):
            j = j[part]
        close(v, j)


def _t(a):
    return torch.from_numpy(np.array(a)).long()


# -- configs and parameters ---------------------------------------------------------
@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_matches_reference(get):
    j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), (get, f)
    for f in ("param_dtype", "compute_dtype"):
        assert str(getattr(t, f)).split(".")[-1] == np.dtype(getattr(j, f)).name, f
    assert t.period == j.period == 5
    assert [t.layer_kind(p) for p in range(5)] == [j.layer_kind(p) for p in range(5)]
    assert t.layer_kind(4) == {"mixer": "cross", "ffn": "mlp"}
    tlm.check_family(t)


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_param_tree_matches_reference(get):
    jc, tc = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    specs = tbase.flatten(tlm.init_specs(tc), is_leaf=lambda x: isinstance(x, tbase.Spec))
    jstruct = jax.tree_util.tree_flatten_with_path(jlm.param_struct(jc))[0]
    assert [k for k, _ in specs] == [jax.tree_util.keystr(k) for k, _ in jstruct]
    assert [s.shape for _, s in specs] == [s.shape for _, s in jstruct]
    if get == "get_config":
        assert tlm.param_count(tc) == (9_775_157_264, 9_775_157_264)  # 19.55 GB in bf16


@pytest.mark.parametrize("arch", [a for a in tconfigs.ARCHS if a != "paper-nn"])
def test_param_count_matches_reference(arch):
    assert tlm.param_count(tconfigs.get_config(arch)) == jlm.param_count(
        jconfigs.get_config(arch))
    assert tlm.param_count(tconfigs.get_smoke_config(arch)) == jlm.param_count(
        jconfigs.get_smoke_config(arch))


def test_cross_cache_shape_matches_reference(models):
    cfg, _, tcfg, _ = models
    for t_img in (0, 5):
        jc = jlm.init_cache(cfg, B, MAX_LEN, img_tokens=t_img)
        tc = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu", img_tokens=t_img)
        assert {k: {n: tuple(a.shape) for n, a in v.items()} for k, v in tc.items()} == {
            k: {n: a.shape for n, a in v.items()} for k, v in jc.items()}


# -- the model ---------------------------------------------------------------------
def test_prefill_decode_logits_cache_and_tokens_match_reference(models):
    cfg, params, tcfg, tparams = models
    jl, jc = jlm.prefill(params, jnp.asarray(PROMPTS), cfg, jlm.init_cache(cfg, B, MAX_LEN),
                         img=jnp.asarray(IMG))
    tl, tc = tlm.prefill(tparams, _t(PROMPTS), tcfg, tlm.init_cache(tcfg, B, MAX_LEN,
                                                                     device="cpu"),
                         img=torch.from_numpy(IMG))
    close(tl, jl)
    cache_close(tc, jc)
    jtok, ttok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32), torch.argmax(tl, -1)[:, None]
    for i in range(N_NEW):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jlm.decode_step(params, jtok, cfg, jc, S0 + i)
        tl, tc = tlm.decode_step(tparams, ttok, tcfg, tc, S0 + i)
        close(tl, jl)
        cache_close(tc, jc)
        jtok, ttok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32), torch.argmax(tl, -1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def _step_tokens(steps, params, cfg, init_cache, toks, img, n):
    """Greedy tokens through a package's ``make_prefill_step`` and
    ``make_serve_step``: (B, n)."""
    pre, serve = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    if steps is jsteps:  # one compile of each step
        pre, serve = jax.jit(pre), jax.jit(serve)
    tok, cache = pre(params, toks, init_cache(), img=img)
    tok, out = tok[:, None], [np.asarray(tok)]
    for i in range(n - 1):
        tok, cache = serve(params, tok, cache, S0 + i)
        assert tuple(tok.shape) == (B, 1)
        out.append(np.asarray(tok)[:, 0])
    return np.stack(out, 1)


def port_tokens(params, tcfg, n=N_NEW, img=IMG):
    return _step_tokens(tsteps, params, tcfg,
                        lambda: tlm.init_cache(tcfg, B, MAX_LEN, device="cpu"),
                        _t(PROMPTS), torch.from_numpy(img), n)


def ref_tokens(params, cfg, n=N_NEW, img=IMG):
    return _step_tokens(jsteps, params, cfg, lambda: jlm.init_cache(cfg, B, MAX_LEN),
                        jnp.asarray(PROMPTS), jnp.asarray(img), n)


def test_serving_steps_tokens_match_reference(models):
    cfg, params, tcfg, tparams = models
    np.testing.assert_array_equal(port_tokens(tparams, tcfg), ref_tokens(params, cfg))


def test_sequence_logits_match_reference_and_prefill(models):
    cfg, params, tcfg, tparams = models
    seq = np.concatenate([PROMPTS, PROMPTS[:, :3]], axis=1)
    tsl = tlm.sequence_logits(tparams, _t(seq), tcfg, img=torch.from_numpy(IMG))
    close(tsl, jlm.sequence_logits(params, jnp.asarray(seq), cfg, img=jnp.asarray(IMG)))
    pl, _ = tlm.prefill(tparams, _t(seq), tcfg, tlm.init_cache(tcfg, B, MAX_LEN, device="cpu"),
                        img=torch.from_numpy(IMG))
    assert torch.equal(tsl[:, -1], pl)


def test_image_changes_the_logits(models):
    """With nonzero gates the cross layers read the image."""
    _, _, tcfg, tparams = models
    a, _ = tlm.prefill(tparams, _t(PROMPTS), tcfg, tlm.init_cache(tcfg, B, MAX_LEN, device="cpu"),
                       img=torch.from_numpy(IMG))
    b, _ = tlm.prefill(tparams, _t(PROMPTS), tcfg, tlm.init_cache(tcfg, B, MAX_LEN, device="cpu"),
                       img=torch.from_numpy(IMG[::-1].copy()))
    assert float((a - b).abs().max()) > 1e-3


def test_cross_attention_is_batch_invariant():
    """Each lane alone gives the batch's row bit for bit, a prefill's rows
    equal one-query calls', and the result matches a float64 softmax."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(3, 5, 4, 16, generator=g)
    k, v = torch.randn(3, 11, 2, 16, generator=g), torch.randn(3, 11, 2, 16, generator=g)
    out = tlm.cross_attention(q, k, v)
    for b in range(3):
        assert torch.equal(tlm.cross_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1]), out[b:b + 1])
        for i in range(5):
            assert torch.equal(tlm.cross_attention(q[b:b + 1, i:i + 1], k[b:b + 1], v[b:b + 1]),
                               out[b:b + 1, i:i + 1])
    q64, k64, v64 = (t.double() for t in (q, k, v))
    k64, v64 = (t.repeat_interleave(2, dim=2) for t in (k64, v64))
    s = torch.einsum("bqhd,bkhd->bhqk", q64, k64) / 4.0
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v64)
    close(out, want.numpy())


def test_zero_gates_make_the_cross_layer_the_identity(models):
    _, _, tcfg, tparams = models
    p = tlm._layer(tparams["blocks"]["p4"], 0)
    p = {**p, "gate_attn": torch.zeros(1), "gate_ffn": torch.zeros(1)}
    x = torch.randn(B, S0, tcfg.d_model, generator=torch.Generator().manual_seed(4))
    c = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")["p4"]
    out = tlm._cross_block(x, p, tcfg, cache=c, g=0, img=torch.from_numpy(IMG), prefill=True)
    assert torch.equal(out, x)
    assert float(c["k"][0].abs().max()) > 0


# -- engines -------------------------------------------------------------------------
def test_inline_engine_matches_reference(models):
    """At smoke width the cross ``wk`` / ``wv`` (64 x 32) are too narrow to
    pack, so the inline forward runs: equal protected keys, planes,
    counters and tokens at 0.56 V under host masks."""
    cfg, params, tcfg, tparams = models
    _, jsizes = jeng.protect_params_inline(params, cfg)
    _, tsizes = teng.protect_params_inline(tparams, tcfg)
    assert tsizes == jsizes and len(tsizes) == 25
    assert "['blocks']['p4']['attn']['wq']" in tsizes
    assert "['blocks']['p4']['attn']['wk']" not in tsizes
    jrel, trel = _rels(platform="vc707", voltage=1.0, mode="inline")
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    for e in (j, t):
        e.set_voltage(0.56)
    assert _stats(t._last_scrub) == _stats(j._last_scrub) and t.stats.corrected > 0
    _same_params(t.params, j.params)
    np.testing.assert_array_equal(port_tokens(t.params, tcfg), ref_tokens(j.params, cfg))


@pytest.mark.parametrize("v", [1.0, 0.56])
def test_domain_mode_engine_matches_reference(models, v):
    """Domain mode writes every leaf (the gates too) and reads the tree back
    through the faults."""
    cfg, params, tcfg, tparams = models
    jrel, trel = _rels(platform="vc707", voltage=v, mode="domain")
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    assert len(t.domain.names()) == len(tbase.flatten(tparams))
    _same_params(t.params, j.params)
    assert _stats(t.stats) == _stats(j.stats)
    if v < 0.6:
        assert t.stats.faulty_words > 0
    np.testing.assert_array_equal(port_tokens(t.params, tcfg), ref_tokens(j.params, cfg))


# -- where the reference fails ---------------------------------------------------------
def test_protected_cross_projection_is_refused():
    """With ``n_kv_heads=4`` the cross ``wk`` / ``wv`` are 64 x 64 and the
    inline key rule packs them; the reference's plain einsum cannot read an
    EccWeight. The port refuses before any fused matmul."""
    cfg, tcfg = configs(n_layers=5, n_kv_heads=4)
    params = gated(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    tparams = pair(params, tcfg)
    jrel, trel = _rels(platform="vc707", voltage=1.0, mode="inline")
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="EccWeight"):
        jlm.prefill(j.params, jnp.asarray(PROMPTS), cfg, jlm.init_cache(cfg, B, MAX_LEN),
                    img=jnp.asarray(IMG))
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    assert isinstance(t.params["blocks"]["p4"]["attn"]["wk"], tops.EccWeight)
    calls = []
    real = tops.ecc_matmul
    tops.ecc_matmul = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        with pytest.raises(ValueError, match=r"blocks\.p4\.attn\.wk"):
            tlm.prefill(t.params, _t(PROMPTS), tcfg,
                        tlm.init_cache(tcfg, B, MAX_LEN, device="cpu"), img=torch.from_numpy(IMG))
    finally:
        tops.ecc_matmul = real
    assert calls == []


def test_generate_is_refused(models):
    cfg, params, tcfg, tparams = models
    j = jeng.ServingEngine(cfg, params, rel=None, max_len=MAX_LEN)
    with pytest.raises(AttributeError):
        j.generate(PROMPTS, 3)
    t = teng.ServingEngine(tcfg, tparams, rel=None, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="generate"):
        t.generate(PROMPTS, 3)


def test_canary_is_refused(models):
    """The canary decodes through ``generate``."""
    _, _, tcfg, tparams = models
    trel = teng.ReliabilityConfig(platform="vc707", voltage=1.0, mode="inline",
                                  canary=teng.CanaryConfig(prompts=2))
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="generate"):
        t.canary_divergence()
    with pytest.raises(ValueError, match="generate"):
        t.autotune_voltage()


def test_prefill_without_an_image_is_refused(models):
    cfg, params, tcfg, tparams = models
    with pytest.raises(AttributeError):
        jlm.prefill(params, jnp.asarray(PROMPTS), cfg, jlm.init_cache(cfg, B, MAX_LEN))
    with pytest.raises(ValueError, match="img="):
        tlm.prefill(tparams, _t(PROMPTS), tcfg, tlm.init_cache(tcfg, B, MAX_LEN, device="cpu"))
    with pytest.raises(ValueError, match="img must be"):
        tlm.prefill(tparams, _t(PROMPTS), tcfg, tlm.init_cache(tcfg, B, MAX_LEN, device="cpu"),
                    img=torch.from_numpy(IMG[:, :5]))


@pytest.mark.parametrize("entry", ["chunk_step", "chunk_logits"])
def test_chunks_are_refused(models, entry):
    """The reference's chunk mode passes no image to the cross layers."""
    cfg, params, tcfg, tparams = models
    jc = jlm.init_cache(cfg, B, MAX_LEN)
    with pytest.raises(AttributeError):
        getattr(jlm, entry)(params, jnp.asarray(PROMPTS[:, :4]), cfg, jc, 0)
    tc = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        getattr(tlm, entry)(tparams, _t(PROMPTS[:, :4]), tcfg, tc, 0)
    with pytest.raises(ValueError, match="chunk"):
        tlm.forward(tparams, _t(PROMPTS[:, :4]), tcfg, tc, 3)


def test_serve_is_refused(models):
    cfg, _, tcfg, tparams = models
    assert not tconfigs.shapes.supports_paged_kv(tcfg)
    assert not jconfigs.shapes.supports_paged_kv(cfg)
    t = teng.ServingEngine(tcfg, tparams, rel=None, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="paged KV unsupported"):
        t.serve([(PROMPTS[0], 3)], n_lanes=1)
