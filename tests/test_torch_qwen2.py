"""Port parity on qwen2-7b's smoke config (``qkv_bias``, GQA, untied
embeddings): the biased QKV projection, prefill, decode steps, greedy
tokens and teacher-forced ``sequence_logits`` against the reference, with
seeded nonzero biases in both packages (``init_params`` draws them as
zeros); the protected leaves of both engines; paged serve against dense
generate in the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving.engine import protect_params_inline as j_protect
from repro_torch import configs as tconfigs
from repro_torch.models import base as tbase
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as teng

# float32 logits: the two packages sum in other orders
LOGIT_RTOL = 1e-4
S0, N_NEW, MAX_LEN = 8, 6, 24
BIASES = ("bq", "bk", "bv")


def biased(params, seed=5):
    """The reference's params with seeded nonzero biases (numpy leaves)."""
    tree = jax.tree_util.tree_map(np.asarray, params)
    attn = tree["blocks"]["p0"]["attn"]
    rng = np.random.default_rng(seed)
    for b in BIASES:
        attn[b] = rng.normal(0.0, 0.5, attn[b].shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def models():
    cfg = jconfigs.get_smoke_config("qwen2-7b")
    tcfg = tconfigs.get_smoke_config("qwen2-7b")
    assert tcfg.qkv_bias and cfg.qkv_bias and not tcfg.tie_embeddings
    tree = biased(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = tbase.params_from_numpy(tree, tcfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, S0)).astype(np.int32)
    return cfg, params, tcfg, tparams, prompts


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=LOGIT_RTOL * np.abs(j).max())


def test_config_matches_reference():
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)("qwen2-7b"), getattr(tconfigs, get)("qwen2-7b")
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                  "vocab", "qkv_bias", "qk_norm", "rope_theta", "tie_embeddings"):
            assert getattr(t, f) == getattr(j, f), (get, f)


def test_init_specs_have_zero_biases():
    tcfg = tconfigs.get_smoke_config("qwen2-7b")
    p = tlm.init_params(tcfg, seed=0, device="cpu")
    attn = p["blocks"]["p0"]["attn"]
    for b, n in zip(BIASES, (tcfg.n_heads, tcfg.n_kv_heads, tcfg.n_kv_heads)):
        assert attn[b].shape == (tcfg.n_groups, n * tcfg.hd) and not attn[b].any()
    no_bias = tlm.init_params(tconfigs.get_smoke_config("qwen3-0.6b"), seed=0, device="cpu")
    assert not set(BIASES) & set(no_bias["blocks"]["p0"]["attn"])


def test_qkv_proj_adds_the_biases(models):
    cfg, params, tcfg, tparams, _ = models
    x = np.random.default_rng(1).normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["p0"]["attn"])
    tp = {k: v[0] for k, v in tparams["blocks"]["p0"]["attn"].items()}
    jq = jlayers.qkv_proj(jnp.asarray(x), jp, cfg)
    tq = tlayers.qkv_proj(torch.from_numpy(x), tp, tcfg)
    for t, j in zip(tq, jq):
        _close(t, j)
    # the biases matter: without them the projections differ
    tp0 = {k: (torch.zeros_like(v) if k in BIASES else v) for k, v in tp.items()}
    assert not torch.allclose(tlayers.qkv_proj(torch.from_numpy(x), tp0, tcfg)[0], tq[0])


def test_prefill_and_decode_match_reference(models):
    cfg, params, tcfg, tparams, prompts = models
    jl, jc = jlm.prefill(params, jnp.asarray(prompts), cfg, jlm.init_cache(cfg, 2, MAX_LEN))
    tc = tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    tl, tc = tlm.prefill(tparams, torch.from_numpy(prompts).long(), tcfg, tc)
    _close(tl, jl)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl, -1)[:, None]
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    for i in range(N_NEW):
        jl, jc = jlm.decode_step(params, jtok, cfg, jc, S0 + i)
        tl, tc = tlm.decode_step(tparams, ttok, tcfg, tc, S0 + i)
        _close(tl, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl, -1)[:, None]
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), i


def test_greedy_decode_loop_tokens_match_reference(models):
    cfg, params, tcfg, tparams, prompts = models
    jl, jc = jlm.prefill(params, jnp.asarray(prompts), cfg, jlm.init_cache(cfg, 2, MAX_LEN))
    jtok0 = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    jt, _ = jlm.greedy_decode_loop(params, jtok0, cfg, jc, S0, N_NEW)
    tc = tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    tl, tc = tlm.prefill(tparams, torch.from_numpy(prompts).long(), tcfg, tc)
    tt, _ = tlm.greedy_decode_loop(tparams, torch.argmax(tl, -1)[:, None], tcfg, tc, S0, N_NEW)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_sequence_logits_match_reference_and_prefill(models):
    cfg, params, tcfg, tparams, prompts = models
    seq = np.concatenate([prompts, prompts[:, :4]], axis=1)
    jl = jlm.sequence_logits(params, jnp.asarray(seq), cfg)
    tl = tlm.sequence_logits(tparams, torch.from_numpy(seq).long(), tcfg)
    assert tl.shape == (2, seq.shape[1], tcfg.vocab) and tl.dtype == torch.float32
    _close(tl, jl)
    # its last position is prefill's logits on the same tokens, bit for bit
    pl, _ = tlm.prefill(tparams, torch.from_numpy(seq).long(), tcfg,
                        tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu"))
    assert torch.equal(tl[:, -1], pl)


def test_protected_leaves_match_reference(models):
    cfg, params, tcfg, tparams, _ = models
    for embed in (False, True):
        _, jsizes = j_protect(params, cfg, include_embed=embed)
        _, tsizes = teng.protect_params_inline(tparams, tcfg, include_embed=embed)
        assert tsizes == jsizes
        assert not any(b in k for k in tsizes for b in BIASES)


def test_engine_generate_matches_reference(models):
    from repro.serving.engine import ReliabilityConfig as JRel
    from repro.serving.engine import ServingEngine as JEngine

    cfg, params, tcfg, tparams, prompts = models
    kw = dict(platform="vc707", voltage=0.56, mode="inline")
    jeng = JEngine(cfg, params, rel=JRel(**kw), max_len=MAX_LEN)
    teng_ = teng.ServingEngine(tcfg, tparams, rel=teng.ReliabilityConfig(**kw),
                               max_len=MAX_LEN, device="cpu")
    assert teng_._last_scrub.to_dict() == jeng._last_scrub.to_dict()
    assert teng_._last_scrub.corrected > 0
    np.testing.assert_array_equal(teng_.generate(prompts, N_NEW), jeng.generate(prompts, N_NEW))


def test_paged_serve_equals_dense_generate(models):
    _, _, tcfg, tparams, prompts = models
    eng = teng.ServingEngine(tcfg, tparams, rel=None, max_len=MAX_LEN, device="cpu")
    dense = eng.generate(prompts, N_NEW)
    rep = eng.serve([(p, N_NEW) for p in prompts], n_lanes=2)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(np.asarray(rep.outputs[i]), dense[i])
