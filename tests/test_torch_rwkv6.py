"""Port parity of the ssm family (``models/rwkv6.py``; rwkv6-3b) against
the reference on its smoke config: the chunked WKV, time-mix and
channel-mix at several lengths from zero and nonzero states, the config
and parameter tree, prefill / decode logits, greedy tokens,
``sequence_logits`` and the recurrent cache, the refusals (chunks, paged
serving, a scan length no equal chunks cover), and the three engines
(single-rail inline with an empty arena, multi-rail inline with the
embedding alone, domain mode) at 0.56 V under host masks."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import rwkv6 as jrwkv
from repro.serving import engine as jeng
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as tops
from repro_torch.models import base as tbase
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv6 as trwkv
from repro_torch.serving import engine as teng
from test_torch_engine_modes import _rels, _same_params, _stats

# float32 logits and states: the two packages sum in other orders
LOGIT_RTOL = 1e-4
ARCH = "rwkv6-3b"
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
          "head_dim", "norm_type", "gated_mlp", "tie_embeddings", "attn_every", "d_state",
          "d_conv", "ssm_expand", "rwkv_head_dim", "n_experts", "moe_every")
S0, N_NEW, MAX_LEN = 10, 6, 24
PROMPTS = np.random.default_rng(0).integers(0, 256, (2, S0)).astype(np.int32)
LENGTHS = (1, 10, 64, 128, 192)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain codecs and fields are many small int64 torch ops: under
    pytest-xdist, workers that each run a thread per core contend for the
    cores; one intra-op thread a worker avoids that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(params, seed=1):
    """The reference's parameters with every zeros / ones leaf (token-shift
    mixes, bonus u, norm gains and shifts) filled with seeded values:
    ``init_params`` draws them constant, which would test nothing."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        a = np.asarray(a)
        key = jax.tree_util.keystr(path)
        if re.search(r"mu_|\['u'\]|ln_x_|gamma|beta|conv_b|dt_bias|d_skip", key):
            a = (rng.standard_normal(a.shape) * 0.3 + (1.0 if "gamma" in key or "_g'" in key
                                                         or "d_skip" in key else 0.0))
            a = a.astype(np.float32)
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(fill, params)


def pair(params, tcfg):
    return tbase.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                   device="cpu")


@pytest.fixture(scope="module")
def models():
    cfg, tcfg = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    params = seeded(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, params, tcfg, pair(params, tcfg)


def _close(t, j, rtol=LOGIT_RTOL):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=rtol * max(np.abs(j).max(), 1e-30))


def _layer0(params, key):
    return jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["p0"][key])


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


# -- configs and parameters ---------------------------------------------------------
@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_matches_reference(get):
    j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), (get, f)
    for f in ("param_dtype", "compute_dtype"):
        assert str(getattr(t, f)).split(".")[-1] == np.dtype(getattr(j, f)).name, f
    assert t.period == j.period == 1 and t.d_inner == j.d_inner
    assert t.layer_kind(0) == j.layer_kind(0) == {"mixer": "rwkv", "ffn": "rwkv_cm"}
    tlm.check_family(t)


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_param_tree_matches_reference(get):
    jc, tc = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    specs = tbase.flatten(tlm.init_specs(tc), is_leaf=lambda x: isinstance(x, tbase.Spec))
    jstruct = jax.tree_util.tree_flatten_with_path(jlm.param_struct(jc))[0]
    assert [k for k, _ in specs] == [jax.tree_util.keystr(k) for k, _ in jstruct]
    assert [s.shape for _, s in specs] == [s.shape for _, s in jstruct]
    total = sum(int(np.prod(s.shape)) for _, s in specs)
    assert total == jlm.param_count(jc)[0]
    if get == "get_config":
        assert total == 3_099_857_920  # 6.20 GB in bf16: one card holds it


def test_decay_leaves_match_reference():
    """``decay`` leaves are linspace(-6, -0.5) over the stacked leaf; they
    draw nothing, so the normal leaves around them keep their draws."""
    tc = tconfigs.get_smoke_config(ARCH)
    jp = jlm.init_params(jconfigs.get_smoke_config(ARCH), jax.random.PRNGKey(0))
    tp = tlm.init_params(tc, seed=0, device="cpu")
    np.testing.assert_allclose(tp["blocks"]["p0"]["tm"]["w_base"].numpy(),
                               np.asarray(jp["blocks"]["p0"]["tm"]["w_base"]), rtol=0, atol=1e-6)
    spec = {"a": tbase.Spec((2, 3)), "b": tbase.Spec((2, 3), "decay"), "c": tbase.Spec((2, 3))}
    got = tbase.materialize(spec, torch.Generator().manual_seed(5), torch.float32, "cpu")
    want = tbase.materialize({"a": spec["a"], "c": spec["c"]},
                             torch.Generator().manual_seed(5), torch.float32, "cpu")
    assert torch.equal(got["a"], want["a"]) and torch.equal(got["c"], want["c"])


# -- the mixers ---------------------------------------------------------------------
def _wkv_inputs(s, nonzero, seed):
    rng = np.random.default_rng(seed)
    b, h, n = 2, 4, 16
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, n)) * 0.5 - 1.0)).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32) * 0.5
    s0 = (rng.standard_normal((b, h, n, n)).astype(np.float32) if nonzero
          else np.zeros((b, h, n, n), np.float32))
    return r, k, v, w, u, s0


@pytest.mark.parametrize("nonzero", [False, True], ids=["zero_state", "state"])
@pytest.mark.parametrize("s", LENGTHS)
def test_wkv_chunked_matches_reference(s, nonzero):
    args = _wkv_inputs(s, nonzero, seed=s)
    jy, js = jrwkv._wkv_chunked(*map(jnp.asarray, args))
    ty, ts = trwkv._wkv_chunked(*map(torch.from_numpy, args))
    _close(ty, jy)
    _close(ts, js)


def _state(b, d, n, nonzero, seed):
    rng = np.random.default_rng(seed)
    shape = lambda *sh: (rng.standard_normal(sh).astype(np.float32) * 0.5 if nonzero
                         else np.zeros(sh, np.float32))
    return {"shift": shape(b, d), "wkv": shape(b, d // n, n, n)}


@pytest.mark.parametrize("nonzero", [None, False, True], ids=["fresh", "zero_state", "state"])
@pytest.mark.parametrize("s", LENGTHS)
def test_time_mix_matches_reference(models, s, nonzero):
    cfg, params, tcfg, _ = models
    p = _layer0(params, "tm")
    x = np.random.default_rng(s).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    st = None if nonzero is None else _state(2, cfg.d_model, cfg.rwkv_head_dim, nonzero, s + 1)
    jo, jst = jrwkv.time_mix(jnp.asarray(x), p, cfg,
                             None if st is None else jax.tree_util.tree_map(jnp.asarray, st))
    to, tst = trwkv.time_mix(torch.from_numpy(x), _t(p), tcfg, None if st is None else _t(st))
    _close(to, jo)
    for k in ("shift", "wkv"):
        _close(tst[k], jst[k])


@pytest.mark.parametrize("nonzero", [None, True], ids=["fresh", "state"])
@pytest.mark.parametrize("s", LENGTHS)
def test_channel_mix_matches_reference(models, s, nonzero):
    cfg, params, tcfg, _ = models
    p = _layer0(params, "cm")
    x = np.random.default_rng(s).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    st = None if nonzero is None else {"shift": np.random.default_rng(s + 2).standard_normal(
        (2, cfg.d_model)).astype(np.float32)}
    jo, jst = jrwkv.channel_mix(jnp.asarray(x), p, cfg,
                                None if st is None else {"shift": jnp.asarray(st["shift"])})
    to, tst = trwkv.channel_mix(torch.from_numpy(x), _t(p), tcfg, None if st is None else _t(st))
    _close(to, jo)
    _close(tst["shift"], jst["shift"])


# -- the model ---------------------------------------------------------------------
def _cache_close(tc, jc):
    for k, v in tbase.flatten(tc):
        j = jc
        for part in re.findall(r"\['([^']*)'\]", k):
            j = j[part]
        _close(v, j)


def test_prefill_decode_tokens_and_cache_match_reference(models):
    cfg, params, tcfg, tparams = models
    jl, jc = jlm.prefill(params, jnp.asarray(PROMPTS), cfg, jlm.init_cache(cfg, 2, MAX_LEN))
    tc = tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    assert sorted(tc["p0"]) == ["shift_cm", "shift_tm", "wkv"]
    assert {k: tuple(v.shape) for k, v in tc["p0"].items()} == {
        k: v.shape for k, v in jlm.init_cache(cfg, 2, MAX_LEN)["p0"].items()}
    tl, tc = tlm.prefill(tparams, torch.from_numpy(PROMPTS).long(), tcfg, tc)
    _close(tl, jl)
    _cache_close(tc, jc)
    jtok, ttok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32), torch.argmax(tl, -1)[:, None]
    for i in range(N_NEW):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jlm.decode_step(params, jtok, cfg, jc, S0 + i)
        tl, tc = tlm.decode_step(tparams, ttok, tcfg, tc, S0 + i)
        _close(tl, jl)
        _cache_close(tc, jc)
        jtok, ttok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32), torch.argmax(tl, -1)[:, None]
    seq = np.concatenate([PROMPTS, np.asarray(jtok)], axis=1)
    tsl = tlm.sequence_logits(tparams, torch.from_numpy(seq).long(), tcfg)
    _close(tsl, jlm.sequence_logits(params, jnp.asarray(seq), cfg))
    # a fresh state: the last position = prefill's logits of the same tokens
    pl, _ = tlm.prefill(tparams, torch.from_numpy(seq).long(), tcfg,
                        tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu"))
    assert torch.equal(tsl[:, -1], pl)


def test_greedy_tokens_match_reference(models):
    cfg, params, tcfg, tparams = models
    j = jeng.ServingEngine(cfg, params, rel=None, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=None, max_len=MAX_LEN, device="cpu")
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))


def test_long_prefill_then_decode_equals_a_longer_prefill(models):
    """prefill(129 tokens) is refused, so the chunked path is held to the
    step path at 128 + 1: prefill(128) then one decode step = the last
    logits of a prefill of the 128 tokens and the next one token by token,
    within the float32 tolerance (the chunked and stepped sums differ)."""
    _, _, tcfg, tparams = models
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 129))).long()
    c = tlm.init_cache(tcfg, 2, 160, device="cpu")
    tlm.prefill(tparams, toks[:, :128], tcfg, c)
    l1, _ = tlm.decode_step(tparams, toks[:, 128:], tcfg, c, 128)
    c2 = tlm.init_cache(tcfg, 2, 160, device="cpu")
    tlm.prefill(tparams, toks[:, :1], tcfg, c2)
    for i in range(1, 129):
        l2, _ = tlm.decode_step(tparams, toks[:, i : i + 1], tcfg, c2, i)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=0,
                               atol=LOGIT_RTOL * float(l2.abs().max()))


# -- refusals ------------------------------------------------------------------------
@pytest.mark.parametrize("entry", ["chunk_step", "chunk_logits", "forward_chunk"])
def test_chunks_are_refused(models, entry):
    """The reference's chunk mode restarts the recurrence from a zero state
    and leaves the cache unwritten; the port refuses a chunk instead."""
    _, _, tcfg, tparams = models
    c = tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    toks = torch.from_numpy(PROMPTS).long()
    calls = {"chunk_step": lambda: tlm.chunk_step(tparams, toks[:, :4], tcfg, c, 0),
             "chunk_logits": lambda: tlm.chunk_logits(tparams, toks[:, :4], tcfg, c, 0),
             "forward_chunk": lambda: tlm.forward(tparams, toks[:, :4], tcfg, c, 3)}
    with pytest.raises(ValueError, match="recurrent"):
        calls[entry]()


def test_serve_is_refused(models):
    _, _, tcfg, tparams = models
    assert not tconfigs.shapes.supports_paged_kv(tcfg)
    t = teng.ServingEngine(tcfg, tparams, rel=None, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="paged KV unsupported"):
        t.serve([(PROMPTS[0], 3)], n_lanes=1)


@pytest.mark.parametrize("s", [129, 131])
def test_scan_lengths_no_equal_chunks_cover_are_refused(models, s):
    """The reference's scan asserts nc * lc == s; the port raises
    ValueError at exactly those lengths."""
    cfg, params, tcfg, tparams = models
    toks = np.random.default_rng(s).integers(0, 256, (1, s)).astype(np.int32)
    with pytest.raises(AssertionError):
        jlm.prefill(params, jnp.asarray(toks), cfg, jlm.init_cache(cfg, 1, s))
    with pytest.raises(ValueError, match="not 2 chunks"):
        tlm.prefill(tparams, torch.from_numpy(toks).long(), tcfg,
                    tlm.init_cache(tcfg, 1, s, device="cpu"))


def test_scan_lengths_that_equal_chunks_cover_are_admitted():
    assert [trwkv.chunks_of(s) for s in (1, 63, 64, 127, 128, 130, 192, 256)] == [
        (1, 1), (1, 63), (1, 64), (1, 127), (2, 64), (2, 65), (3, 64), (4, 64)]
    for s in (129, 131, 193):
        with pytest.raises(ValueError):
            trwkv.chunks_of(s)


# -- engines -------------------------------------------------------------------------
def _walk(j, t):
    jl, jh = j.autotune_voltage()
    tl, th = t.autotune_voltage()
    rec = lambda h: [(r.voltage, r.corrected, r.detected, r.action) for r in h]
    return jl, jh, tl, th, rec


def test_single_rail_inline_engine_has_an_empty_arena(models):
    """rwkv6's leaves are keyed ``tm`` / ``cm``: the inline key rule (``attn``
    or ``mlp``) protects none of them. The engine builds an empty arena,
    steps, walks and locks as the reference does, and launches nothing."""
    cfg, params, tcfg, tparams = models
    _, jsizes = jeng.protect_params_inline(params, cfg)
    _, tsizes = teng.protect_params_inline(tparams, tcfg)
    assert tsizes == jsizes == {}
    jrel, trel = _rels(platform="vc707", voltage=1.0, mode="inline", rails=dict(start_v=0.62))
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=MAX_LEN)
    tops.reset_launch_count()
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    assert t._store.n_words == 0 and t._store.groups == ()
    for e in (j, t):
        e.set_voltage(0.56)
    assert _stats(t._last_scrub) == _stats(j._last_scrub)
    assert t._last_scrub.words == 0
    _same_params(t.params, j.params)
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))
    for e in (j, t):
        e.set_voltage(e.controller.voltage)
    jl, jh, tl, th, rec = _walk(j, t)
    assert tl == jl and rec(th) == rec(jh) and t.controller.locked == j.controller.locked
    assert _stats(t.stats) == _stats(j.stats) and t.power_report() == j.power_report()
    assert sum(tops.launch_counts().values()) == 0


def test_multi_rail_inline_engine_protects_the_embedding_alone(models):
    cfg, params, tcfg, tparams = models
    _, jsizes = jeng.protect_params_inline(params, cfg, include_embed=True)
    _, tsizes = teng.protect_params_inline(tparams, tcfg, include_embed=True)
    assert tsizes == jsizes == {"['embed']": cfg.vocab * cfg.d_model // 8}
    jrel, trel = _rels(platform="vc707", voltage=1.0, mode="inline",
                       rails=dict(multi_rail=True, start_v=0.62))
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    assert t._store.domains == tuple(j._store.domains) == ("embedding",)
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))
    for e in (j, t):
        e.set_rails({"embedding": 0.56})
    _same_params(t.params, j.params)
    assert _stats(t.stats) == _stats(j.stats) and t.stats.faulty_words > 0
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))
    jv, jh = j.autotune_voltage()
    tv, th = t.autotune_voltage()
    rec = lambda h: [(r.voltage, r.corrected, r.detected, r.action) for r in h]
    assert tv == jv and {d: rec(h) for d, h in th.items()} == {d: rec(h) for d, h in jh.items()}
    assert _stats(t.stats) == _stats(j.stats) and t.power_report() == j.power_report()


@pytest.mark.parametrize("v", [1.0, 0.56])
def test_domain_mode_engine_matches_reference(models, v):
    """Domain mode writes every leaf (the embedding, time-mix, channel-mix
    and norms) and reads the tree back through the faults."""
    cfg, params, tcfg, tparams = models
    jrel, trel = _rels(platform="vc707", voltage=v, mode="domain")
    j = jeng.ServingEngine(cfg, params, rel=jrel, max_len=MAX_LEN)
    t = teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu")
    assert len(t.domain.names()) == len(tbase.flatten(tparams))
    _same_params(t.params, j.params)
    assert _stats(t.stats) == _stats(j.stats)
    np.testing.assert_array_equal(t.generate(PROMPTS, N_NEW), j.generate(PROMPTS, N_NEW))
    if v < 0.6:
        assert t.stats.faulty_words > 0
        jl, jh, tl, th, rec = _walk(j, t)
        assert tl == jl and rec(th) == rec(jh)
        assert _stats(t.stats) == _stats(j.stats) and t.power_report() == j.power_report()


def test_family_admission():
    """The six families are admitted at their published configs; an unknown
    family is refused."""
    for arch in ("qwen3-0.6b", "mixtral-8x22b", "rwkv6-3b", "jamba-1.5-large-398b",
                 "llama-3.2-vision-11b", "musicgen-medium"):
        tlm.check_family(tconfigs.get_config(arch))
    q = tconfigs.get_smoke_config("qwen3-0.6b")
    with pytest.raises(NotImplementedError, match="'diffusion' family"):
        tlm.init_specs(dataclasses.replace(q, family="diffusion"))
