"""Port parity for the paged path's model entry points: decode with a (B,)
position vector, chunked prefill (``chunk_step``) and the speculative verify
block (``chunk_logits``) against the reference on the tiny config, and the
port's one attention path (a chunk equals the same tokens decoded one by
one)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_cfg
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.models import base as tbase
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

# float32 logits: the two packages sum in other orders
LOGIT_RTOL = 1e-4
S0 = 8


@pytest.fixture(scope="module")
def models():
    cfg = tiny_cfg()
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = tbase.ModelConfig(
        name=cfg.name, family=cfg.family, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab,
        head_dim=cfg.head_dim,
    )
    tparams = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu"
    )
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, S0)).astype(np.int32)
    return cfg, params, tcfg, tparams, prompts


def _prefilled(models, max_len=24):
    cfg, params, tcfg, tparams, prompts = models
    _, jc = jlm.prefill(params, jnp.asarray(prompts), cfg, jlm.init_cache(cfg, 2, max_len))
    tc = tlm.init_cache(tcfg, 2, max_len, device="cpu")
    tlm.prefill(tparams, torch.from_numpy(prompts).long(), tcfg, tc)
    return jc, tc


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=LOGIT_RTOL * np.abs(j).max())
    np.testing.assert_array_equal(t.numpy().argmax(-1), j.argmax(-1))


def _cache_close(tc, jc):
    for name in ("k", "v"):
        j = np.asarray(jc["p0"][name])
        np.testing.assert_allclose(tc["p0"][name].numpy(), j, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(j).max())


@pytest.mark.parametrize("pos", [[S0, S0], [S0, 5], [3, S0 + 2]])
def test_decode_step_position_vector(models, pos):
    cfg, params, tcfg, tparams, prompts = models
    jc, tc = _prefilled(models)
    tok = prompts[:, -1:]
    jl, jc = jlm.decode_step(params, jnp.asarray(tok), cfg, jc, jnp.asarray(pos, jnp.int32))
    tl, tc = tlm.decode_step(tparams, torch.from_numpy(tok).long(), tcfg, tc, torch.tensor(pos))
    _close(tl, jl)
    _cache_close(tc, jc)


def test_decode_step_scalar_is_a_vector_of_equal_positions(models):
    cfg, params, tcfg, tparams, prompts = models
    _, tc1 = _prefilled(models)
    _, tc2 = _prefilled(models)
    tok = torch.from_numpy(prompts[:, -1:]).long()
    a, _ = tlm.decode_step(tparams, tok, tcfg, tc1, S0)
    b, _ = tlm.decode_step(tparams, tok, tcfg, tc2, torch.tensor([S0, S0]))
    assert torch.equal(a, b)


@pytest.mark.parametrize("pos0", [[S0, S0], [S0, 4]])
@pytest.mark.parametrize("fn", ["chunk_step", "chunk_logits"])
def test_chunk_entry_points_match_reference(models, pos0, fn):
    cfg, params, tcfg, tparams, prompts = models
    jc, tc = _prefilled(models)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    jl, jc = getattr(jlm, fn)(params, jnp.asarray(toks), cfg, jc, jnp.asarray(pos0, jnp.int32))
    tl, tc = getattr(tlm, fn)(tparams, torch.from_numpy(toks).long(), tcfg, tc,
                              torch.tensor(pos0))
    _close(tl, jl)
    _cache_close(tc, jc)


def test_chunk_logits_equal_stepwise_decode(models):
    """One attention path: verifying k tokens in one chunk gives the floats
    of decoding them one by one."""
    cfg, params, tcfg, tparams, prompts = models
    _, tc1 = _prefilled(models)
    _, tc2 = _prefilled(models)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 4))).long()
    full, _ = tlm.chunk_logits(tparams, toks, tcfg, tc1, S0)
    for i in range(4):
        step, _ = tlm.decode_step(tparams, toks[:, i : i + 1], tcfg, tc2, S0 + i)
        assert torch.equal(full[:, i], step), i


def test_prefill_equals_prefix_then_chunk(models):
    """A prompt prefilled whole and the same prompt as prefix + chunk give
    the same last-token logits (the shared-prefix admission path)."""
    cfg, params, tcfg, tparams, prompts = models
    toks = torch.from_numpy(prompts).long()
    whole, _ = tlm.prefill(tparams, toks, tcfg, tlm.init_cache(tcfg, 2, 24, device="cpu"))
    c = tlm.init_cache(tcfg, 2, 24, device="cpu")
    tlm.prefill(tparams, toks[:, :4], tcfg, c)
    split, _ = tlm.chunk_step(tparams, toks[:, 4:], tcfg, c, 4)
    assert torch.equal(whole, split)


def test_decode_attention_per_lane_lengths():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    cur = np.array([20, 7, 1], np.int32)
    j = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cur))
    t = tlayers.decode_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(cur).long())
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("how", ["query_blocks", "key_bound", "batch_of_one"])
def test_chunk_attention_rows_do_not_depend_on_the_call(monkeypatch, dtype, how):
    """A row's attention output is the same floats whether the query rows
    are walked in one block or many, whatever host bound on the keys is
    given, and whether its lane is alone in the call."""
    rng = np.random.default_rng(4)
    b, sq, smax = 3, 6, 37
    q = torch.from_numpy(rng.standard_normal((b, sq, 4, 16)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal((b, smax, 2, 16)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal((b, smax, 2, 16)).astype(np.float32)).to(dtype)
    pos0 = torch.tensor([0, 9, 25])
    ref = tlayers.chunk_attention(q, k, v, pos0)
    if how == "query_blocks":
        monkeypatch.setattr(tlayers, "ATTN_BLOCK_ELEMS", 1)
        for bound in (None, 31):
            assert torch.equal(tlayers.chunk_attention(q, k, v, pos0, bound), ref)
    elif how == "key_bound":
        for bound in (31, 32, 33, 64, 100):
            assert torch.equal(tlayers.chunk_attention(q, k, v, pos0, bound), ref)
    else:
        for i in range(b):
            one = tlayers.chunk_attention(q[i : i + 1], k[i : i + 1], v[i : i + 1], pos0[i : i + 1],
                                          int(pos0[i]) + sq)
            assert torch.equal(one[0], ref[i]), i


@pytest.mark.parametrize("n", [1, 3, tlm.LOGIT_ROWS, tlm.LOGIT_ROWS + 5])
def test_logits_rows_do_not_depend_on_the_row_count(models, n):
    _, _, tcfg, tparams, _ = models
    h = torch.from_numpy(np.random.default_rng(5).standard_normal((40, tcfg.d_model))
                         .astype(np.float32))
    all_rows = tlm._logits(tparams, h, tcfg)
    assert torch.equal(tlm._logits(tparams, h[:n], tcfg), all_rows[:n])
    assert torch.equal(tlm._logits(tparams, h[-n:], tcfg), all_rows[-n:])


def test_unembed_cast_once_and_again_after_a_write(models):
    _, _, tcfg, tparams, _ = models
    key = "embed" if tcfg.tie_embeddings else "lm_head"
    p = {**tparams, key: tparams[key].to(torch.bfloat16)}
    a = tlm._unembed_f32(p, tcfg)
    assert a.dtype == torch.float32 and tlm._unembed_f32(p, tcfg).data_ptr() == a.data_ptr()
    p[key].mul_(2)
    b = tlm._unembed_f32(p, tcfg)
    assert torch.equal(b, 2 * a)
