"""Port parity for the rest of the dense family: LayerNorm, the non-gated
gelu / relu^2 MLPs, the sliding-window ring cache and the int8 KV cache,
and the qwen1.5-4b and minitron-8b configs, against the reference on smoke
configs with seeded nonzero norms and biases (``init_params`` draws betas
and biases as zeros). Prefill, decode steps, greedy tokens,
``sequence_logits`` and the cache's slot layout per variant; the protected
leaves of both engines; the refusals of paged serving and chunks."""

import dataclasses

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
# a 14-token prompt wraps the 8-slot ring
S0, N_NEW, MAX_LEN, WINDOW = 14, 6, 24, 8
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
          "head_dim", "qkv_bias", "qk_norm", "norm_type", "gated_mlp", "mlp_act", "rope_theta",
          "sliding_window", "tie_embeddings", "kv_quant")

# (name, arch, options on its smoke config)
VARIANTS = {
    "minitron-8b": ("minitron-8b", {}),
    "qwen1.5-4b": ("qwen1.5-4b", {}),
    "layernorm": ("qwen3-0.6b", {"norm_type": "layernorm"}),
    "gelu": ("qwen3-0.6b", {"gated_mlp": False, "mlp_act": "gelu"}),
    "window": ("qwen3-0.6b", {"sliding_window": WINDOW}),
    "kv_quant": ("qwen3-0.6b", {"kv_quant": True}),
}


def perturbed(params, seed=5):
    """The reference's params as numpy leaves with seeded norm gains and
    nonzero norm shifts and QKV biases."""
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k in ("bq", "bk", "bv"):
                node[k] = rng.normal(0.0, 0.5, v.shape).astype(np.float32)
            elif k == "beta":
                node[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
            elif k == "gamma":
                node[k] = (1.0 + rng.normal(0.0, 0.2, v.shape)).astype(np.float32)

    fill(tree)
    return tree


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=LOGIT_RTOL * np.abs(j).max())


def _configs(name):
    arch, opts = VARIANTS[name]
    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **opts)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **opts)
    return cfg, tcfg


def _cache_np(c):
    return {k: v.numpy().copy() for k, v in c["p0"].items()}


@pytest.fixture(scope="module", params=list(VARIANTS))
def run(request):
    """One prefill and N_NEW greedy decode steps in both packages, each
    side decoding its own argmax, and ``sequence_logits`` of the prompt and
    the tokens; logits, tokens and caches of both."""
    cfg, tcfg = _configs(request.param)
    tree = perturbed(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = tbase.params_from_numpy(tree, tcfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, S0)).astype(np.int32)
    out = {"name": request.param, "cfg": cfg, "tcfg": tcfg, "params": params,
           "tparams": tparams, "prompts": prompts, "j": [], "t": []}
    jl, jc = jlm.prefill(params, jnp.asarray(prompts), cfg, jlm.init_cache(cfg, 2, MAX_LEN))
    tc = tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    tl, tc = tlm.prefill(tparams, torch.from_numpy(prompts).long(), tcfg, tc)
    out["prefill_cache"] = ({k: np.asarray(v) for k, v in jc["p0"].items()}, _cache_np(tc))
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl, -1)[:, None]
    out["j"].append((np.asarray(jl), np.asarray(jtok)))
    out["t"].append((tl, ttok.numpy()))
    for i in range(N_NEW):
        jl, jc = jlm.decode_step(params, jtok, cfg, jc, S0 + i)
        tl, tc = tlm.decode_step(tparams, ttok, tcfg, tc, S0 + i)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl, -1)[:, None]
        out["j"].append((np.asarray(jl), np.asarray(jtok)))
        out["t"].append((tl, ttok.numpy()))
    out["cache"] = ({k: np.asarray(v) for k, v in jc["p0"].items()}, _cache_np(tc))
    seq = np.concatenate([prompts] + [t for _, t in out["t"][:-1]], axis=1)
    out["seq"] = seq
    out["seq_logits"] = (np.asarray(jlm.sequence_logits(params, jnp.asarray(seq), cfg)),
                         tlm.sequence_logits(tparams, torch.from_numpy(seq).long(), tcfg))
    return out


# -- configs ------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "minitron-8b"])
@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_matches_reference(arch, get):
    j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), (get, f)
    for f in ("param_dtype", "compute_dtype"):
        assert str(getattr(t, f)).split(".")[-1] == np.dtype(getattr(j, f)).name, f
    assert set(f.name for f in dataclasses.fields(t)) <= set(
        f.name for f in dataclasses.fields(j))


@pytest.mark.parametrize("arch,lo,hi", [("qwen1.5-4b", 3.7e9, 4.2e9),
                                        ("minitron-8b", 7.3e9, 8.3e9)])
def test_param_count_matches_reference(arch, lo, hi):
    specs = tbase.flatten(tlm.init_specs(tconfigs.get_config(arch)),
                          is_leaf=lambda x: isinstance(x, tbase.Spec))
    total = sum(int(np.prod(s.shape)) for _, s in specs)
    assert total == jlm.param_count(jconfigs.get_config(arch))[0]
    assert lo <= total <= hi


def test_specs_follow_the_options():
    _, tcfg = _configs("minitron-8b")
    keys = [k for k, _ in tbase.flatten(tlm.init_specs(tcfg),
                                        is_leaf=lambda x: isinstance(x, tbase.Spec))]
    jcfg, _ = _configs("minitron-8b")
    jkeys = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(
        jlm.init_specs(jcfg), is_leaf=lambda x: isinstance(x, jlm.Spec))[0]]
    assert keys == jkeys and not any("w3" in k for k in keys)
    _, lcfg = _configs("layernorm")
    p = tlm.init_params(lcfg, seed=0, device="cpu")
    for ln in ("ln1", "ln2"):
        assert sorted(p["blocks"]["p0"][ln]) == ["beta", "gamma"]
        assert not p["blocks"]["p0"][ln]["beta"].any()
    assert sorted(p["final_norm"]) == ["beta", "gamma"]


# -- layers ---------------------------------------------------------------------
def test_layer_norm_and_activations_match_reference():
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=(3, 5, 64)) + 1.5).astype(np.float32)
    gamma, beta = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    j = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    t = tlayers.layer_norm(*map(torch.from_numpy, (x, gamma, beta)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    p = {"gamma": torch.from_numpy(gamma), "beta": torch.from_numpy(beta)}
    assert torch.equal(tlayers.apply_norm(torch.from_numpy(x), p, "layernorm"), t)
    assert torch.equal(tlayers.apply_norm(torch.from_numpy(x), p, "rmsnorm"),
                       tlayers.rms_norm(torch.from_numpy(x), p["gamma"]))
    for act in ("gelu", "relu2", "silu"):
        j = jlayers._ACTS[act](jnp.asarray(x))
        t = tlayers._ACTS[act](torch.from_numpy(x))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6, err_msg=act)
    # the tanh form: the exact erf form differs from the reference
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - np.asarray(jlayers._ACTS["gelu"](jnp.asarray(x)))).max() > 1e-5


def test_layer_norm_rows_do_not_depend_on_the_batch():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(16, 3, 96)).astype(np.float32))
    gamma, beta = torch.full((96,), 1.5), torch.full((96,), -0.25)
    full = tlayers.layer_norm(x, gamma, beta)
    for i in (0, 7, 15):
        assert torch.equal(tlayers.layer_norm(x[i:i + 1], gamma, beta), full[i:i + 1])


def test_quant_kv_matches_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    k = rng.normal(0.0, 2.0, (2, 9, 4, 16)).astype(np.float32)
    v = rng.normal(0.0, 0.5, (2, 9, 4, 16)).astype(np.float32)
    k[0, 3] = 0.0  # an all-zero row takes the 1e-9 floor
    v[1, 2, 1, :5] = 127.5 * (v[1, 2, 1, :5] > 0)  # ties at the rounding point
    jq = jlm._quant_kv(jnp.asarray(k), jnp.asarray(v))
    tq = tlm._quant_kv(torch.from_numpy(k), torch.from_numpy(v))
    for t, j in zip(tq, jq):
        assert t.dtype == (torch.int8 if j.dtype == jnp.int8 else torch.float32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jd = jlm._dequant_kv(*jq, jdt)
        td = tlm._dequant_kv(*tq, tdt)
        for t, j in zip(td, jd):
            assert t.dtype == tdt
            np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                          np.asarray(j).astype(np.float32))


def test_window_masks_keys_outside_it():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(2, 5, 4, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 16, 2, 8)).astype(np.float32))
            for _ in range(2))
    pos0 = torch.tensor([3, 9])
    out = tlayers.chunk_attention(q, k, v, pos0, window=4)
    # keys outside (qpos - 4, qpos] do not count: overwriting them changes
    # nothing, row by row
    for i in range(5):
        for b in range(2):
            lo_, hi_ = int(pos0[b]) + i - 3, int(pos0[b]) + i
            kk, vv = k.clone(), v.clone()
            kk[b, : max(lo_, 0)], vv[b, : max(lo_, 0)] = 9.0, 9.0
            kk[b, hi_ + 1:], vv[b, hi_ + 1:] = -9.0, -9.0
            o = tlayers.chunk_attention(q[b:b + 1, i:i + 1], kk[b:b + 1], vv[b:b + 1],
                                        pos0[b:b + 1] + i, window=4)
            assert torch.equal(o, out[b:b + 1, i:i + 1]), (b, i)
    jd = jlayers.decode_attention(jnp.asarray(q[:, :1].numpy()), jnp.asarray(k.numpy()),
                                  jnp.asarray(v.numpy()), jnp.asarray(pos0.numpy() + 1), window=4)
    td = tlayers.chunk_attention(q[:, :1], k, v, pos0, window=4)  # decode at cur_len - 1
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)


# -- each variant against the reference ---------------------------------------
def test_prefill_and_decode_logits_match_reference(run):
    for i, ((jl, _), (tl, _)) in enumerate(zip(run["j"], run["t"])):
        assert tl.shape == jl.shape and tl.dtype == torch.float32, i
        _close(tl, jl)


def test_greedy_tokens_match_reference(run):
    jt = np.concatenate([t for _, t in run["j"]], axis=1)
    tt = np.concatenate([t for _, t in run["t"]], axis=1)
    np.testing.assert_array_equal(tt, jt)
    # the port's decode loop takes the same path as its steps
    tcfg, tparams, prompts = run["tcfg"], run["tparams"], run["prompts"]
    tc = tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    tl, tc = tlm.prefill(tparams, torch.from_numpy(prompts).long(), tcfg, tc)
    loop, _ = tlm.greedy_decode_loop(tparams, torch.argmax(tl, -1)[:, None], tcfg, tc, S0, N_NEW)
    np.testing.assert_array_equal(loop.numpy(), tt[:, 1:])


def test_sequence_logits_match_reference(run):
    jl, tl = run["seq_logits"]
    assert tl.shape == (2, run["seq"].shape[1], run["tcfg"].vocab)
    _close(tl, jl)
    # windowed and unquantised: its prompt positions are prefill's
    assert torch.equal(tl[:, S0 - 1], run["t"][0][0])


def test_cache_layout_matches_reference(run):
    """The cache's shapes, dtypes and slots are the reference's: a ring of
    WINDOW slots holds position p in slot p % WINDOW, an int8 cache the same
    planes and scales (a K/V element on a rounding boundary may round to
    either neighbour, the two packages' K/V differing in their last bits)."""
    for (jc, tc) in (run["prefill_cache"], run["cache"]):
        assert sorted(tc) == sorted(jc)
        for name in jc:
            j, t = jc[name], tc[name]
            assert t.shape == j.shape and t.dtype == j.dtype, name
            if t.dtype == np.int8:
                d = np.abs(t.astype(np.int32) - j.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() < 1e-3, name
            else:
                np.testing.assert_allclose(t, j, rtol=0, atol=LOGIT_RTOL * np.abs(j).max(),
                                           err_msg=name)
    if run["name"] == "window":
        assert run["cache"][1]["k"].shape[2] == WINDOW


def test_ring_decode_equals_the_full_cache_windowed_decode():
    """The ring against a position-indexed cache of MAX_LEN (built for the
    config without its window) with the window as a mask, on the same
    tokens: every step's logits bit for bit (the key sums' upper tree levels
    fold positions onto slots, adding exact zeros), and slot j holding the
    K/V of the position p = j mod WINDOW in every layer."""
    _, tcfg = _configs("window")
    p = tbase.params_from_numpy(perturbed(jlm.init_params(_configs("window")[0],
                                                          jax.random.PRNGKey(0))), tcfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, tcfg.vocab, (2, S0 + N_NEW)))
    ring = tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    full = tlm.init_cache(dataclasses.replace(tcfg, sliding_window=0), 2, MAX_LEN, device="cpu")
    assert ring["p0"]["k"].shape[2] == WINDOW and full["p0"]["k"].shape[2] == MAX_LEN
    rl, _ = tlm.prefill(p, toks[:, :S0], tcfg, ring)
    fl, _ = tlm.prefill(p, toks[:, :S0], tcfg, full)
    assert torch.equal(rl, fl)

    def layout(layers_):
        n = S0 + len(steps)
        for pos in range(n - WINDOW, n):
            for name in ("k", "v"):
                r = ring["p0"][name][layers_, :, pos % WINDOW]
                f = full["p0"][name][layers_, :, pos]
                assert torch.equal(r, f), (name, pos)

    steps = []
    layout(slice(None))
    for i in range(N_NEW):
        pos = S0 + i
        rl, _ = tlm.decode_step(p, toks[:, pos:pos + 1], tcfg, ring, pos)
        fl, _ = tlm.decode_step(p, toks[:, pos:pos + 1], tcfg, full, pos)
        steps.append(i)
        assert torch.equal(rl, fl), i
    layout(slice(None))


# -- engines and refusals -------------------------------------------------------
def test_protected_leaves_match_reference():
    cfg, tcfg = _configs("minitron-8b")
    tree = perturbed(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = tbase.params_from_numpy(tree, tcfg, device="cpu")
    for embed in (False, True):
        _, jsizes = j_protect(params, cfg, include_embed=embed)
        _, tsizes = teng.protect_params_inline(tparams, tcfg, include_embed=embed)
        assert tsizes == jsizes
        assert not any("w3" in k or "beta" in k for k in tsizes)
        assert sum("mlp" in k for k in tsizes) == 2


def test_paged_serve_equals_dense_generate_qwen1_5():
    _, tcfg = _configs("qwen1.5-4b")
    assert tcfg.qkv_bias and tcfg.n_kv_heads == tcfg.n_heads
    tree = perturbed(jlm.init_params(_configs("qwen1.5-4b")[0], jax.random.PRNGKey(0)))
    tparams = tbase.params_from_numpy(tree, tcfg, device="cpu")
    eng = teng.ServingEngine(tcfg, tparams, rel=None, max_len=MAX_LEN, device="cpu")
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, tcfg.vocab, n).astype(np.int32), k)
            for n, k in ((9, 5), (4, 7), (13, 3))]
    rep = eng.serve(reqs, n_lanes=2)
    for i, (prompt, n) in enumerate(reqs):
        np.testing.assert_array_equal(np.asarray(rep.outputs[i]),
                                      eng.generate(prompt[None], n)[0])


@pytest.mark.parametrize("opts", [{"sliding_window": WINDOW}, {"kv_quant": True}])
def test_paged_serve_and_chunks_refuse_ring_and_int8_caches(opts):
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("qwen3-0.6b"), **opts)
    assert not tconfigs.shapes.supports_paged_kv(tcfg)
    assert tconfigs.shapes.supports_paged_kv(tconfigs.get_smoke_config("qwen3-0.6b"))
    params = tlm.init_params(tcfg, seed=0, device="cpu")
    eng = teng.ServingEngine(tcfg, params, rel=None, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="paged KV"):
        eng.serve([(np.arange(4, dtype=np.int32), 2)], n_lanes=1)
    cache = tlm.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    toks = torch.arange(3)[None]
    for fn in (tlm.chunk_step, tlm.chunk_logits):
        with pytest.raises(ValueError, match="chunks"):
            fn(params, toks, tcfg, cache, 2)
