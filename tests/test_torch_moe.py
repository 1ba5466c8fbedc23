"""Port parity of the MoE family (``models/moe.py``; mixtral-8x22b and
llama4-scout-17b-a16e) against the reference on smoke configs: routing and
the sort dispatch bit for bit (ties and drops included), ``moe_ffn`` for
the gated, non-gated and shared-expert forms in decode and per-row
grouping, prefill logits and greedy tokens and the refusals (a depth
that is not a whole number of periods, the vlm and audio families); within the
port, row invariance and the dispatch against a plain per-token mixture.
The engines are in ``test_torch_moe_engine.py``."""

import dataclasses

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import base as tbase
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.serving import engine as teng

# float32 logits and expert sums: the two packages sum in other orders
LOGIT_RTOL = 1e-4
ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e")
MOE_FIELDS = ("n_experts", "top_k", "moe_every", "shared_expert", "capacity_factor")
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
          "head_dim", "qkv_bias", "qk_norm", "norm_type", "gated_mlp", "mlp_act", "rope_theta",
          "sliding_window", "tie_embeddings", "kv_quant") + MOE_FIELDS
S0, N_NEW, MAX_LEN = 10, 6, 24
PROMPTS = np.random.default_rng(0).integers(0, 256, (2, S0)).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain codecs and fields are many small int64 torch ops: under
    pytest-xdist, workers that each run a thread per core contend for the
    cores; one intra-op thread a worker avoids that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, **opts):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **opts),
            dataclasses.replace(tconfigs.get_smoke_config(arch), **opts))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg, tcfg = _pair(request.param)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tbase.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                      device="cpu")
    return cfg, params, tcfg, tparams


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=LOGIT_RTOL * np.abs(j).max())


# -- configs and parameters ---------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_matches_reference(arch, get):
    j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), (get, f)
    for f in ("param_dtype", "compute_dtype"):
        assert str(getattr(t, f)).split(".")[-1] == np.dtype(getattr(j, f)).name, f
    assert t.period == j.period == 1
    assert t.layer_kind(0) == j.layer_kind(0) == {"mixer": "attn", "ffn": "moe"}


@pytest.mark.parametrize("arch,lo,hi", [("mixtral-8x22b", 1.35e11, 1.45e11),
                                        ("llama4-scout-17b-a16e", 1.0e11, 1.15e11)])
def test_specs_and_param_count_match_reference(arch, lo, hi):
    for get in ("get_config", "get_smoke_config"):
        jc, tc = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        specs = tbase.flatten(tlm.init_specs(tc), is_leaf=lambda x: isinstance(x, tbase.Spec))
        jspecs = jax.tree_util.tree_flatten_with_path(
            jlm.init_specs(jc), is_leaf=lambda x: isinstance(x, jlm.Spec))[0]
        assert [k for k, _ in specs] == [jax.tree_util.keystr(k) for k, _ in jspecs]
        assert [s.shape for _, s in specs] == [s.shape for _, s in jspecs]
        total = sum(int(np.prod(s.shape)) for _, s in specs)
        assert total == jlm.param_count(jc)[0]
        assert lo <= total <= hi or get == "get_smoke_config"


def test_expert_leaves_are_drawn_one_matrix_at_a_time():
    """A 4-D leaf's expert matrices are the generator's draws in order,
    each N(0, 1) / sqrt(fan_in), cast to the parameter dtype; 3-D leaves
    keep their one whole draw."""
    spec = {"a": tbase.Spec((2, 3, 8, 5)), "b": tbase.Spec((2, 8, 5))}
    gen = torch.Generator().manual_seed(3)
    got = tbase.materialize(spec, gen, torch.bfloat16, "cpu")
    gen = torch.Generator().manual_seed(3)
    want = [(torch.randn((8, 5), generator=gen) * (1 / np.sqrt(8))).to(torch.bfloat16)
            for _ in range(6)]
    assert torch.equal(got["a"].reshape(6, 8, 5), torch.stack(want))
    b = (torch.randn((2, 8, 5), generator=gen) * (1 / np.sqrt(8))).to(torch.bfloat16)
    assert torch.equal(got["b"], b)


# -- routing and dispatch -------------------------------------------------------------
def _router_inputs(d, e, seed):
    """Token rows with ties: two equal rows, a zero row (every expert equal),
    and a router whose last two columns are equal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 8, d)).astype(np.float32)
    x[0, 3] = x[0, 1]
    x[1, 2] = 0.0
    w = rng.standard_normal((d, e)).astype(np.float32) / np.sqrt(d)
    w[:, -1] = w[:, -2]
    return x, w


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 1), (4, 1)])
def test_route_topk_matches_reference(e, k):
    x, w = _router_inputs(64, e, seed=e * 10 + k)
    jidx, jprobs, jlogits = jmoe.route_topk(jnp.asarray(x), jnp.asarray(w), e, k)
    tidx, tprobs, tlogits = tmoe.route_topk(torch.from_numpy(x), torch.from_numpy(w), e, k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tlogits, jlogits)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-6)
    # the zero row ties every expert: the k lowest indices, as jax.lax.top_k
    np.testing.assert_array_equal(tidx[1, 2].numpy(), np.arange(k))


@pytest.mark.parametrize("t,k,e,cf", [(8, 2, 4, 1.25), (4, 1, 16, 1.25), (32, 2, 8, 1.25),
                                      (5, 2, 4, 2.0), (1, 1, 16, 16.0), (3, 2, 8, 1.0)])
def test_capacity_matches_reference(t, k, e, cf):
    """(4, 1, 16, 1.25): llama4-scout's 4-lane decode group gets one slot
    an expert; (8, 2, 4, 1.25): round(5.0); (32, 2, 8, 1.25): round(10.0)."""
    assert tmoe.capacity(t, k, e, cf) == int(max(1, round(t * k / e * cf)))


def _dispatch_pair(idx, e, cap):
    j = jax.vmap(lambda i: jmoe.sort_dispatch(i, e, cap))(jnp.asarray(idx, jnp.int32))
    t = tmoe.sort_dispatch(torch.from_numpy(idx).long(), e, cap)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return t


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [1, 9])
def test_sort_dispatch_matches_reference_at_cf_1_25(arch, s):
    """The smoke configs' routing at the published capacity factor, decode
    grouping (one group) and per-row grouping; assignments drop."""
    _, tcfg = _pair(arch)
    x, w = _router_inputs(tcfg.d_model, tcfg.n_experts, seed=s)
    xg = x[:, :s].reshape(1, -1, tcfg.d_model) if s == 1 else x[:, :s]
    idx, _, _ = tmoe.route_topk(torch.from_numpy(xg), torch.from_numpy(w), tcfg.n_experts,
                                tcfg.top_k)
    cap = tmoe.capacity(xg.shape[1], tcfg.top_k, tcfg.n_experts, 1.25)
    _, _, kept = _dispatch_pair(idx.numpy(), tcfg.n_experts, cap)
    assert (~kept).any() or s == 1


@settings(max_examples=12, deadline=None)
@given(t=st.integers(1, 40), e=st.sampled_from([2, 4, 8, 16]), k=st.integers(1, 2),
       cap=st.integers(1, 48), g=st.integers(1, 3))
def test_sort_dispatch_matches_reference_property(t, e, k, cap, g):
    rng = np.random.default_rng(t * 1000 + e * 10 + k)
    idx = np.stack([np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
                    for _ in range(g)])
    _dispatch_pair(idx, e, cap)


# -- the MoE feed-forward ---------------------------------------------------------
FFN_CASES = {
    "gated": ("mixtral-8x22b", {}),
    "non_gated": ("mixtral-8x22b", {"gated_mlp": False, "mlp_act": "relu2"}),
    "shared": ("llama4-scout-17b-a16e", {}),
    "no_drop": ("mixtral-8x22b", {"capacity_factor": 2.0}),
}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
@pytest.mark.parametrize("b,s", [(4, 1), (3, 9)])
def test_moe_ffn_matches_reference(case, b, s):
    arch, opts = FFN_CASES[case]
    cfg, tcfg = _pair(arch, **opts)
    spec = jlm._moe_spec(cfg)
    from repro.models import base as jbase
    p = jbase.materialize(spec, jax.random.PRNGKey(1), jnp.float32)
    tp = tbase.tree_map(lambda a: torch.from_numpy(np.array(a)), dict(p))
    x = np.random.default_rng(b * s).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jout, _ = jmoe.moe_ffn(jnp.asarray(x), p, cfg)
    _close(tmoe.moe_ffn(torch.from_numpy(x), tp, tcfg), jout)


def _plain_mixture(x, p, cfg):
    """Each token alone through its top-k experts (no capacity, no slot
    grid), each expert output times its probability in the compute dtype,
    added in expert order; the shared expert after."""
    d = x.shape[-1]
    rows = x.reshape(-1, d)
    idx, probs, _ = tmoe.route_topk(rows, p["router"], cfg.n_experts, cfg.top_k)
    out = []
    for r in range(rows.shape[0]):
        acc = rows.new_zeros(d)
        for j in torch.argsort(idx[r]).tolist():
            ye = tmoe._expert_ffn(rows[r].reshape(1, 1, 1, d),
                                  {k: v[idx[r, j]][None] for k, v in p.items()
                                   if k in ("w1", "w2", "w3")}, cfg).reshape(d)
            acc = acc + ye * probs[r, j]
        if cfg.shared_expert:
            h = torch.nn.functional.silu(tmoe._rows(rows[r:r + 1], p["shared_w1"]))
            acc = acc + tmoe._rows(h * tmoe._rows(rows[r:r + 1], p["shared_w3"]),
                                   p["shared_w2"])[0]
        out.append(acc)
    return torch.stack(out).reshape(x.shape)


def test_moe_rows_do_not_depend_on_the_batch_and_equal_the_plain_mixture(models):
    """At a no-drop capacity (cf = E / k) each token's output is the same
    bits in a batch of 4 and alone, in decode and per-row grouping, and
    equals the per-token mixture bit for bit."""
    _, _, tcfg, tparams = models
    tcfg = dataclasses.replace(tcfg, capacity_factor=tcfg.n_experts / tcfg.top_k)
    p = {k: v[0] for k, v in tparams["blocks"]["p0"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 5, tcfg.d_model))
                         .astype(np.float32))
    for xs in (x[:, :1], x):
        full = tmoe.moe_ffn(xs, p, tcfg)
        for r in range(4):
            assert torch.equal(tmoe.moe_ffn(xs[r:r + 1], p, tcfg)[0], full[r])
        assert torch.equal(full, _plain_mixture(xs, p, tcfg))


# -- the model ---------------------------------------------------------------------
def test_prefill_decode_and_greedy_tokens_match_reference(models):
    cfg, params, tcfg, tparams = models
    jl, jc = jlm.prefill(params, jnp.asarray(PROMPTS), cfg, jlm.init_cache(cfg, 2, MAX_LEN))
    tc = tlm.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    tl, tc = tlm.prefill(tparams, torch.from_numpy(PROMPTS).long(), tcfg, tc)
    _close(tl, jl)
    jtok, ttok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32), torch.argmax(tl, -1)[:, None]
    for i in range(N_NEW):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jlm.decode_step(params, jtok, cfg, jc, S0 + i)
        tl, tc = tlm.decode_step(tparams, ttok, tcfg, tc, S0 + i)
        _close(tl, jl)
        jtok, ttok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32), torch.argmax(tl, -1)[:, None]
    seq = np.concatenate([PROMPTS, np.asarray(jtok)], axis=1)
    _close(tlm.sequence_logits(tparams, torch.from_numpy(seq).long(), tcfg),
           jlm.sequence_logits(params, jnp.asarray(seq), cfg))


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "forward", "engine"])
def test_moe_every_above_one_is_refused_naming_jamba(models, entry):
    """``moe_every > 1`` came with jamba's period positions p0, p1, ... and
    is admitted (``test_torch_mamba.py`` holds it against the reference);
    what every entry point still refuses is a depth that is not a whole
    number of periods, which the reference asserts."""
    _, _, tcfg, tparams = models
    assert sorted(tlm.init_specs(dataclasses.replace(tcfg, moe_every=2))["blocks"]) == [
        "p0", "p1"]
    c = dataclasses.replace(tcfg, moe_every=3)  # 2 layers, periods of 3
    calls = {
        "init_params": lambda: tlm.init_params(c, seed=0, device="cpu"),
        "init_cache": lambda: tlm.init_cache(c, 1, 8, device="cpu"),
        "forward": lambda: tlm.forward(tparams, torch.zeros(1, 2, dtype=torch.long), c,
                                       tlm.init_cache(tcfg, 1, 8, device="cpu"), 0),
        "engine": lambda: teng.ServingEngine(c, tparams, rel=teng.ReliabilityConfig(),
                                             device="cpu"),
    }
    with pytest.raises(ValueError, match="whole number of periods"):
        calls[entry]()


def test_other_families_are_refused():
    """All six families are ported (each registered smoke config builds its
    spec tree); a family outside them is refused."""
    fams = {c.family for c in map(tconfigs.get_smoke_config, tconfigs.ARCHS)
            if c.family != "mlp"}
    assert fams == set(tlm.FAMILIES) == {"dense", "moe", "ssm", "hybrid", "vlm", "audio"}
    for arch in tconfigs.ARCHS:
        c = tconfigs.get_smoke_config(arch)
        if c.family != "mlp":
            tlm.init_specs(c)
    c = dataclasses.replace(tconfigs.get_smoke_config("qwen3-0.6b"), family="diffusion")
    with pytest.raises(NotImplementedError, match="'diffusion' family"):
        tlm.init_specs(c)
