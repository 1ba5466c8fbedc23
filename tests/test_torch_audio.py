"""Port parity of the audio family (musicgen-medium: (B, K, S) tokens of
four EnCodec codebooks, their embeddings summed with a sinusoid of the
position, one head per codebook) against the reference on its smoke config:
the config and parameter tree, prefill and decode logits, caches and greedy
tokens through ``lm`` and through ``make_prefill_step`` /
``make_serve_step`` ((B, K, 1) tokens), the decode step's sinusoid swap,
the inline single-rail and multi-rail engines (the codebook tables a
stacked embedding leaf) and domain mode at 0.56 V under host masks, and each
input where the reference fails (a vector position, the decode loop,
chunks, ``sequence_logits``, ``generate``, paged serving), which the port
refuses with ``ValueError``."""

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
from repro_torch.models import base as tbase
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as teng
from repro_torch.serving import steps as tsteps
from test_torch_engine_modes import _rels, _same_params, _stats
from test_torch_vlm import FIELDS, _one_torch_thread, cache_close, close, pair  # noqa: F401

ARCH = "musicgen-medium"
B, K, S0, N_NEW, MAX_LEN = 2, 4, 8, 5, 24
PROMPTS = np.random.default_rng(0).integers(0, 64, (B, K, S0)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    cfg, tcfg = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    # LayerNorm gains and shifts, drawn as ones / zeros, seeded
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.3
                                    + ("gamma" in jax.tree_util.keystr(path)))
        if "gamma" in jax.tree_util.keystr(path) or "beta" in jax.tree_util.keystr(path) else a,
        params)
    return cfg, params, tcfg, pair(params, tcfg)


def _t(a):
    return torch.from_numpy(np.array(a)).long()


# -- configs and parameters ---------------------------------------------------------
@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_matches_reference(get):
    j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    for f in FIELDS + ("mlp_act",):
        assert getattr(t, f) == getattr(j, f), (get, f)
    for f in ("param_dtype", "compute_dtype"):
        assert str(getattr(t, f)).split(".")[-1] == np.dtype(getattr(j, f)).name, f
    assert t.period == j.period == 1 and t.layer_kind(0) == j.layer_kind(0)
    tlm.check_family(t)


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_param_tree_matches_reference(get):
    jc, tc = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    specs = tbase.flatten(tlm.init_specs(tc), is_leaf=lambda x: isinstance(x, tbase.Spec))
    jstruct = jax.tree_util.tree_flatten_with_path(jlm.param_struct(jc))[0]
    assert [k for k, _ in specs] == [jax.tree_util.keystr(k) for k, _ in jstruct]
    assert [s.shape for _, s in specs] == [s.shape for _, s in jstruct]
    if get == "get_config":
        assert tlm.param_count(tc) == (1_384_418_304, 1_384_418_304)  # 2.77 GB in bf16
        assert dict(specs)["['embed']"].shape == (4, 2048, 1536)


@pytest.mark.parametrize("s,offset", [(1, 0), (1, 37), (9, 0), (5, 1000)])
def test_sinusoid_matches_reference(s, offset):
    close(tlm._sinusoid(s, 64, torch.float32, "cpu", offset=offset),
          jlm._sinusoid(s, 64, jnp.float32, offset=offset), rtol=1e-6)


# -- the model ---------------------------------------------------------------------
def test_prefill_decode_logits_cache_and_tokens_match_reference(models):
    cfg, params, tcfg, tparams = models
    jl, jc = jlm.prefill(params, jnp.asarray(PROMPTS), cfg, jlm.init_cache(cfg, B, MAX_LEN))
    tl, tc = tlm.prefill(tparams, _t(PROMPTS), tcfg, tlm.init_cache(tcfg, B, MAX_LEN,
                                                                     device="cpu"))
    assert tuple(tl.shape) == (B, K, tcfg.vocab)
    close(tl, jl)
    cache_close(tc, jc)
    jtok = jnp.argmax(jl, -1)[..., None].astype(jnp.int32)
    ttok = torch.argmax(tl, -1)[..., None]
    for i in range(N_NEW):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jlm.decode_step(params, jtok, cfg, jc, S0 + i)
        tl, tc = tlm.decode_step(tparams, ttok, tcfg, tc, S0 + i)
        close(tl, jl)
        cache_close(tc, jc)
        jtok = jnp.argmax(jl, -1)[..., None].astype(jnp.int32)
        ttok = torch.argmax(tl, -1)[..., None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_decode_step_equals_a_longer_prefill(models):
    """prefill(S0 + 1)'s last logits = prefill(S0) + a decode step: the
    step's sinusoid swap gives position S0 its own sinusoid."""
    _, _, tcfg, tparams = models
    full, _ = tlm.prefill(tparams, _t(PROMPTS), tcfg, tlm.init_cache(tcfg, B, MAX_LEN,
                                                                      device="cpu"))
    c = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")
    tlm.prefill(tparams, _t(PROMPTS[..., :-1]), tcfg, c)
    step, _ = tlm.decode_step(tparams, _t(PROMPTS[..., -1:]), tcfg, c, S0 - 1)
    close(step, full.numpy())


def _step_tokens(steps, params, cfg, init_cache, toks, n):
    pre, serve = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    if steps is jsteps:  # one compile of each step
        pre, serve = jax.jit(pre), jax.jit(serve)
    tok, cache = pre(params, toks, init_cache())
    tok, out = tok[..., None], [np.asarray(tok)]
    for i in range(n - 1):
        tok, cache = serve(params, tok, cache, S0 + i)
        assert tuple(tok.shape) == (B, K, 1)
        out.append(np.asarray(tok)[..., 0])
    return np.stack(out, -1)


def port_tokens(params, tcfg, n=N_NEW):
    return _step_tokens(tsteps, params, tcfg,
                        lambda: tlm.init_cache(tcfg, B, MAX_LEN, device="cpu"), _t(PROMPTS), n)


def ref_tokens(params, cfg, n=N_NEW):
    return _step_tokens(jsteps, params, cfg, lambda: jlm.init_cache(cfg, B, MAX_LEN),
                        jnp.asarray(PROMPTS), n)


def test_serving_steps_tokens_match_reference(models):
    cfg, params, tcfg, tparams = models
    np.testing.assert_array_equal(port_tokens(tparams, tcfg), ref_tokens(params, cfg))


# -- engines -------------------------------------------------------------------------
@pytest.mark.parametrize("multi", [False, True], ids=["single_rail", "multi_rail"])
def test_inline_engine_matches_reference(models, multi):
    """Six protected matrices a layer; a multi-rail engine adds the (4, V,
    D) codebook tables as one stacked embedding leaf, decoded back into a
    float table at every rail step."""
    cfg, params, tcfg, tparams = models
    _, jsizes = jeng.protect_params_inline(params, cfg, include_embed=multi)
    _, tsizes = teng.protect_params_inline(tparams, tcfg, include_embed=multi)
    assert tsizes == jsizes and len(tsizes) == 6 + multi
    rails = dict(multi_rail=True) if multi else {}
    jrel, trel = _rels(platform="vc707", voltage=1.0, mode="inline", rails=rails)
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    for e in (j, t):
        if multi:
            e.set_rails({d: 0.56 for d in e._store.domains})
        else:
            e.set_voltage(0.56)
    if multi:
        assert t._store.domains == tuple(j._store.domains)
        assert tuple(t.params["embed"].shape) == (K, cfg.vocab, cfg.d_model)
    assert _stats(t.stats) == _stats(j.stats) and t.stats.corrected > 0
    _same_params(t.params, j.params)
    np.testing.assert_array_equal(port_tokens(t.params, tcfg), ref_tokens(j.params, cfg))


@pytest.mark.parametrize("v", [1.0, 0.56])
def test_domain_mode_engine_matches_reference(models, v):
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
def test_vector_positions_are_refused(models):
    cfg, params, tcfg, tparams = models
    jl, jc = jlm.prefill(params, jnp.asarray(PROMPTS), cfg, jlm.init_cache(cfg, B, MAX_LEN))
    tok = np.asarray(jnp.argmax(jl, -1)[..., None])
    with pytest.raises(TypeError):
        jlm.decode_step(params, jnp.asarray(tok), cfg, jc, jnp.full((B,), S0, jnp.int32))
    tc = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")
    tlm.prefill(tparams, _t(PROMPTS), tcfg, tc)
    for pos in (torch.full((B,), S0), [S0] * B, np.full((B,), S0)):
        with pytest.raises(ValueError, match="scalar position"):
            tlm.decode_step(tparams, _t(tok), tcfg, tc, pos)
    with pytest.raises(ValueError, match=r"tokens must be \(B, 4, S\)"):
        tlm.prefill(tparams, _t(PROMPTS[:, 0]), tcfg, tc)


def test_greedy_decode_loop_is_refused(models):
    cfg, params, tcfg, tparams = models
    jl, jc = jlm.prefill(params, jnp.asarray(PROMPTS), cfg, jlm.init_cache(cfg, B, MAX_LEN))
    tok = jnp.argmax(jl, -1)[..., None].astype(jnp.int32)
    with pytest.raises(TypeError):
        jlm.greedy_decode_loop(params, tok, cfg, jc, S0, 3)
    tc = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="greedy_decode_loop"):
        tlm.greedy_decode_loop(tparams, _t(np.asarray(tok)), tcfg, tc, S0, 3)


@pytest.mark.parametrize("entry", ["chunk_step", "chunk_logits", "sequence_logits",
                                   "forward_chunk"])
def test_chunks_and_sequence_logits_are_refused(models, entry):
    cfg, params, tcfg, tparams = models
    toks = PROMPTS[..., :4]
    jcalls = {"chunk_step": lambda: jlm.chunk_step(params, jnp.asarray(toks), cfg,
                                                   jlm.init_cache(cfg, B, MAX_LEN), 0),
              "chunk_logits": lambda: jlm.chunk_logits(params, jnp.asarray(toks), cfg,
                                                       jlm.init_cache(cfg, B, MAX_LEN), 0),
              "sequence_logits": lambda: jlm.sequence_logits(params, jnp.asarray(toks), cfg)}
    if entry in jcalls:
        with pytest.raises(AssertionError):
            jcalls[entry]()
    tc = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")
    tcalls = {"chunk_step": lambda: tlm.chunk_step(tparams, _t(toks), tcfg, tc, 0),
              "chunk_logits": lambda: tlm.chunk_logits(tparams, _t(toks), tcfg, tc, 0),
              "sequence_logits": lambda: tlm.sequence_logits(tparams, _t(toks), tcfg),
              "forward_chunk": lambda: tlm.forward(tparams, _t(toks), tcfg, tc, 3)}
    with pytest.raises(ValueError, match="codebook"):
        tcalls[entry]()


def test_generate_and_serve_are_refused(models):
    cfg, params, tcfg, tparams = models
    j = jeng.ServingEngine(cfg, params, rel=None, max_len=MAX_LEN)
    with pytest.raises(ValueError):
        j.generate(PROMPTS[:, 0], 3)
    t = teng.ServingEngine(tcfg, tparams, rel=None, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="generate"):
        t.generate(PROMPTS[:, 0], 3)
    assert not tconfigs.shapes.supports_paged_kv(tcfg)
    assert not jconfigs.shapes.supports_paged_kv(cfg)
    with pytest.raises(ValueError, match="paged KV unsupported"):
        t.serve([(PROMPTS[0, 0], 3)], n_lanes=1)
