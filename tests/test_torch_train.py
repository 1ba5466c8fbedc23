"""Port parity for the training path: the data pipeline, AdamW, the train
forward's loss and gradients for every LM family, the train-mode attention
forms, remat and microbatching.

The reference's weights are carried across with ``params_from_numpy``
(a vlm's cross gates, drawn as zeros, seeded nonzero so its cross layers
take part); losses and gradients are float32 on both sides."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS
from repro.configs import get_smoke_config as jget_smoke
from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.data import pipeline as tpipe
from repro_torch.models import base as tbase
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tstep

LM_ARCHS = [a for a in ARCHS if a != "paper-nn"]
LOSS_RTOL = 1e-5  # the first step's loss, relative
GRAD_TOL = 1e-4  # each gradient leaf, x max |reference gradient| of the leaf
ADAMW_RTOL = 1e-6


def _configs(arch):
    j, t = jget_smoke(arch), tget_smoke(arch)
    if j.n_experts:  # no drops: the two packages' dispatch then agree
        j = dataclasses.replace(j, capacity_factor=8.0)
        t = dataclasses.replace(t, capacity_factor=8.0)
    return j, t


def _ref_params(cfg, seed=0):
    """The reference's draw as numpy, the cross gates seeded nonzero."""
    params = jlm.init_params(cfg, jax.random.PRNGKey(seed))
    g = np.random.default_rng(seed + 1)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for path, leaf in leaves:
        a = np.asarray(leaf, np.float32)
        if re.search(r"gate_(attn|ffn)", jax.tree_util.keystr(path)):
            a = g.uniform(-0.9, 0.9, a.shape).astype(np.float32)
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out)


def _batch(cfg, b=2, s=16, seed=1):
    g = np.random.default_rng(seed)
    shape = (b, cfg.n_codebooks, s) if cfg.n_codebooks else (b, s)
    batch = {"tokens": g.integers(0, cfg.vocab, shape).astype(np.int32),
             "labels": g.integers(0, cfg.vocab, shape).astype(np.int32)}
    batch["labels"][..., -2:] = -1  # masked positions
    if cfg.family == "vlm":
        batch["img"] = g.standard_normal((b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _ref_value_and_grad(cfg, params, batch, remat=None):
    fn = jax.value_and_grad(lambda p, b: jlm.train_loss(p, b, cfg, remat=remat), has_aux=True)
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, dict(
        tbase.flatten(jax.tree_util.tree_map(np.asarray, grads)))


def _port_value_and_grad(tcfg, tparams, batch, remat=None, microbatches=1):
    tc = tstep.TrainConfig(remat=remat, microbatches=microbatches)
    return tstep._value_and_grad(tstep.make_loss_fn(tcfg, tc), tparams,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})


# -- data pipeline -----------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(vocab=64, global_batch=8, seq_len=32),
    dict(vocab=2048, global_batch=4, seq_len=17, seed=3, noise=0.3, n_codebooks=4),
    dict(vocab=151936, global_batch=8, seq_len=9, n_hosts=2, host_id=1),
    dict(vocab=2, global_batch=2, seq_len=5),
])
def test_pipeline_batches_are_the_references_bit_for_bit(kw):
    j, t = jpipe.TokenPipeline(jpipe.DataConfig(**kw)), tpipe.TokenPipeline(tpipe.DataConfig(**kw))
    assert t.local_batch == j.local_batch
    for step in (0, 1, 7, 1000):
        jb, tb = j.batch_at(step), t.batch_at(step)
        assert set(tb) == set(jb) == {"tokens", "labels"}
        for k in jb:
            assert tb[k].dtype == jb[k].dtype and tb[k].shape == jb[k].shape
            np.testing.assert_array_equal(tb[k], jb[k])
    assert np.array_equal(next(iter(t))["tokens"], t.batch_at(0)["tokens"])


# -- AdamW ---------------------------------------------------------------------
@pytest.mark.parametrize("step", ["warmup_start", "warmup", "total", "past"])
def test_schedule_is_the_references_exactly(step):
    cfg_j = jadamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    cfg_t = tadamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    steps = {"warmup_start": [0, 1], "warmup": [10], "total": [50], "past": [70]}[step]
    for s in steps:
        j = np.asarray(jadamw.schedule(cfg_j, jnp.asarray(s, jnp.int32)))
        t = tadamw.schedule(cfg_t, torch.tensor(s, dtype=torch.int32))
        assert t.dtype == torch.float32 and t.item() == float(j), (s, t.item(), float(j))


def _adamw_inputs(seed=0):
    g = np.random.default_rng(seed)
    shapes = {"a": (16, 8), "b": {"c": (5,), "d": (3, 4, 2)}}
    draw = lambda: jax.tree_util.tree_map(
        lambda s: g.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    return draw(), draw(), draw(), np.abs(draw()["a"])


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_agrees_with_the_reference(state_dtype, clip):
    params, grads, m, _ = _adamw_inputs()
    v = jax.tree_util.tree_map(lambda a: np.abs(a) * 0.01, m)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=clip)
    jcfg = jadamw.AdamWConfig(state_dtype=jnp.bfloat16 if state_dtype else None, **kw)
    tcfg = tadamw.AdamWConfig(state_dtype=torch.bfloat16 if state_dtype else None, **kw)
    to_t = lambda tree, dt=torch.float32: tbase.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(dt),
        jax.tree_util.tree_map(np.asarray, tree))
    sdt_j = jnp.bfloat16 if state_dtype else jnp.float32
    jstate = {"m": jax.tree_util.tree_map(lambda a: jnp.asarray(a, sdt_j), m),
              "v": jax.tree_util.tree_map(lambda a: jnp.asarray(a, sdt_j), v),
              "step": jnp.asarray(4, jnp.int32)}
    sdt_t = torch.bfloat16 if state_dtype else torch.float32
    tstate = {"m": to_t(jstate["m"], sdt_t), "v": to_t(jstate["v"], sdt_t),
              "step": torch.tensor(4, dtype=torch.int32)}
    jp, js, jm = jadamw.update(grads, jstate, params, jcfg)
    tp, ts, tm = tadamw.update(to_t(grads), tstate, to_t(params), tcfg)
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0 and int(ts["step"]) == 5
    np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=ADAMW_RTOL)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=ADAMW_RTOL)
    for jt, tt in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        ref = dict(tbase.flatten(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), jt)))
        for key, leaf in tbase.flatten(tt):
            assert leaf.dtype == (sdt_t if tt is not tp else torch.float32)
            np.testing.assert_allclose(leaf.to(torch.float32).numpy(), ref[key],
                                       rtol=ADAMW_RTOL if leaf.dtype == torch.float32 else 1e-2,
                                       atol=1e-7)


def test_adamw_init_zero_moments_and_int32_step():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16), "b": torch.ones(2)}
    st = tadamw.init(params, tadamw.AdamWConfig(state_dtype=torch.bfloat16))
    assert st["step"].dtype == torch.int32 and st["step"].ndim == 0
    for tree in (st["m"], st["v"]):
        for _, leaf in tbase.flatten(tree):
            assert leaf.dtype == torch.bfloat16 and not leaf.any()
    assert tadamw.init(params, tadamw.AdamWConfig())["m"]["w"].dtype == torch.float32


# -- the train forward, loss and gradients -----------------------------------
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_loss_and_gradients_agree_with_the_reference(arch):
    cfg, tcfg = _configs(arch)
    params = _ref_params(cfg)
    batch = _batch(cfg)
    jl, jmetrics, jgrads = _ref_value_and_grad(cfg, params, batch)
    tparams = tbase.params_from_numpy(params, tcfg, device="cpu")
    tl, tmetrics, tgrads = _port_value_and_grad(tcfg, tparams, batch)
    np.testing.assert_allclose(tl.item(), jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tmetrics["ce"].item(), jmetrics["ce"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tmetrics["aux"].item(), jmetrics["aux"], rtol=LOSS_RTOL,
                               atol=1e-7)
    assert (jmetrics["aux"] > 0) == bool(cfg.n_experts)
    flat = tbase.flatten(tgrads)
    assert [k for k, _ in flat] == sorted(jgrads) == [k for k, _ in tbase.flatten(tparams)]
    for key, g in flat:
        ref = jgrads[key]
        assert g.shape == ref.shape and g.dtype == torch.float32, key
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(ref).max(), 1e-30), err_msg=key)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b", "musicgen-medium"])
def test_remat_policies_are_equal_bit_for_bit(arch):
    _, tcfg = _configs(arch)
    tparams = tlm.init_params(tcfg, seed=0, device="cpu")
    batch = _batch(tcfg)
    out = {r: _port_value_and_grad(tcfg, tparams, batch, remat=r) for r in tlm.REMAT_POLICIES}
    l0, _, g0 = out[None]
    for r in ("full", "dots"):
        l1, _, g1 = out[r]
        assert torch.equal(l1, l0), r
        for (k, a), (_, b) in zip(tbase.flatten(g0), tbase.flatten(g1)):
            assert torch.equal(a, b), (r, k)
    with pytest.raises(ValueError):
        _port_value_and_grad(tcfg, tparams, batch, remat="everything")


def test_microbatches_agree_with_one_batch():
    _, tcfg = _configs("qwen3-0.6b")
    tparams = tlm.init_params(tcfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, b=4).items()}
    batch["labels"][..., -2:] = 0  # every microbatch counts the same labels
    outs = []
    for n in (1, 2):
        tc = tstep.TrainConfig(microbatches=n, remat=None)
        new_p, new_s, m = tstep.make_train_step(tcfg, tc)(
            tparams, tadamw.init(tparams, tc.optimizer), batch)
        outs.append((m, new_p))
    (m1, p1), (m2, p2) = outs
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(m2["grad_norm"].item(), m1["grad_norm"].item(), rtol=1e-5)
    for (k, a), (_, b) in zip(tbase.flatten(p1), tbase.flatten(p2)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_train_step_and_eval_step_agree_with_the_reference():
    from repro.train import train_step as jstep

    cfg, tcfg = _configs("qwen3-0.6b")
    params = _ref_params(cfg)
    batch = _batch(cfg)
    jtc = jstep.TrainConfig(remat=None)
    jopt = jadamw.init(params, jtc.optimizer)
    jp, _, jm = jstep.make_train_step(cfg, jtc)(params, jopt, {k: jnp.asarray(v) for k, v in
                                                               batch.items()})
    je = jstep.make_eval_step(cfg, jtc)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = tbase.params_from_numpy(params, tcfg, device="cpu")
    ttc = tstep.TrainConfig(remat=None)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp, ts, tm = tstep.make_train_step(tcfg, ttc)(tparams, tadamw.init(tparams, ttc.optimizer),
                                                  tb)
    te = tstep.make_eval_step(tcfg, ttc)(tparams, tb)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(te[k].item(), float(je[k]), rtol=LOSS_RTOL, atol=1e-7)
    assert not te["loss"].requires_grad
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=LOSS_RTOL)
    assert int(ts["step"]) == 1
    ref = dict(tbase.flatten(jax.tree_util.tree_map(np.asarray, jp)))
    for k, v in tbase.flatten(tp):
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=0, atol=1e-6, err_msg=k)
    assert tbase.flatten(tparams)[0][1] is not tbase.flatten(tp)[0][1]  # not updated in place


def test_chunked_xent_agrees_with_the_reference():
    g = np.random.default_rng(0)
    hidden = g.standard_normal((2, 24, 16)).astype(np.float32)
    un = g.standard_normal((16, 40)).astype(np.float32)
    labels = g.integers(-1, 40, (2, 24)).astype(np.int32)
    for chunk in (512, 16, 5):  # one chunk; 16 halved to 8; 5 halved to 2
        j = float(jlm.chunked_xent(jnp.asarray(hidden), jnp.asarray(un), jnp.asarray(labels),
                                   chunk=chunk))
        t = tlm.chunked_xent(torch.from_numpy(hidden), torch.from_numpy(un),
                             torch.from_numpy(labels), chunk=chunk).item()
        np.testing.assert_allclose(t, j, rtol=LOSS_RTOL)
    all_masked = tlm.chunked_xent(torch.from_numpy(hidden), torch.from_numpy(un),
                                  torch.full((2, 24), -1))
    assert all_masked.item() == 0.0


# -- the train-mode attention forms and the MoE aux --------------------------
def _qkv(b, sq, skv, h, hkv, dh, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((b, sq, h, dh)).astype(np.float32),
            g.standard_normal((b, skv, hkv, dh)).astype(np.float32),
            g.standard_normal((b, skv, hkv, dh)).astype(np.float32))


def _close(t, j, rtol=1e-5):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=rtol * np.abs(j).max())


@pytest.mark.parametrize("causal,window,sq,skv", [
    (True, 0, 12, 12), (True, 4, 12, 12), (False, 0, 6, 10), (True, 0, 5, 9)])
def test_full_attention_agrees_with_the_reference(causal, window, sq, skv):
    q, k, v = _qkv(2, sq, skv, 4, 2, 8)
    j = jlayers.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               window=window)
    t = tlayers.full_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    _close(t, j)


@pytest.mark.parametrize("causal,sq,skv,qc,kc", [
    (True, 16, 16, 4, 4), (True, 16, 16, 8, 4), (False, 12, 20, 4, 5), (True, 8, 16, 4, 8)])
def test_flash_attention_agrees_with_the_reference(causal, sq, skv, qc, kc):
    q, k, v = _qkv(2, sq, skv, 4, 2, 8, seed=1)
    j = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                q_chunk=qc, kv_chunk=kc)
    t = tlayers.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, q_chunk=qc,
                                kv_chunk=kc)
    _close(t, j)


@pytest.mark.parametrize("window,sq,qc", [(4, 16, 4), (6, 12, 12), (8, 24, 8)])
def test_banded_attention_agrees_with_the_reference(window, sq, qc):
    q, k, v = _qkv(2, sq, sq, 4, 2, 8, seed=2)
    j = jlayers.banded_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                                 q_chunk=qc)
    t = tlayers.banded_attention(*map(torch.from_numpy, (q, k, v)), window=window, q_chunk=qc)
    _close(t, j)
    # the band is the direct product with the window as a mask
    _close(t, jlayers.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     window=window))


@pytest.mark.parametrize("form", ["banded", "flash", "flash_cross"])
def test_train_loss_through_the_chunked_attention_forms(form, monkeypatch):
    """The reference picks the band for a window shorter than the sequence
    and the flash form at 4,096 tokens or more (2,048 for a vlm's cross
    attention); the threshold is lowered here in both packages' attention
    by routing ``full_attention`` to the flash form at small chunks."""
    arch = {"banded": "qwen3-0.6b", "flash": "qwen3-0.6b",
            "flash_cross": "llama-3.2-vision-11b"}[form]
    cfg, tcfg = _configs(arch)
    if form == "banded":
        cfg = dataclasses.replace(cfg, sliding_window=8, flash_chunk=8)
        tcfg = dataclasses.replace(tcfg, sliding_window=8, flash_chunk=8)
    else:
        jflash, tflash = jlayers.flash_attention, tlayers.flash_attention
        monkeypatch.setattr(jlayers, "full_attention", lambda q, k, v, causal=True, window=0:
                            jflash(q, k, v, causal=causal, q_chunk=4, kv_chunk=k.shape[1] // 2))
        monkeypatch.setattr(tlayers, "full_attention", lambda q, k, v, causal=True, window=0:
                            tflash(q, k, v, causal=causal, q_chunk=4, kv_chunk=k.shape[1] // 2))
    params = _ref_params(cfg)
    batch = _batch(cfg)
    jl, _, jgrads = _ref_value_and_grad(cfg, params, batch)
    tl, _, tgrads = _port_value_and_grad(tcfg, tbase.params_from_numpy(params, tcfg, "cpu"),
                                         batch)
    np.testing.assert_allclose(tl.item(), jl, rtol=LOSS_RTOL)
    for key, g in tbase.flatten(tgrads):
        ref = jgrads[key]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(ref).max(), 1e-30), err_msg=key)


def test_load_balance_loss_agrees_with_the_reference():
    g = np.random.default_rng(0)
    logits = g.standard_normal((40, 8)).astype(np.float32)
    idx = g.integers(0, 8, (40, 2)).astype(np.int32)
    j = float(jmoe.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), 8))
    t = tmoe.load_balance_loss(torch.from_numpy(logits), torch.from_numpy(idx).long(), 8)
    np.testing.assert_allclose(t.item(), j, rtol=1e-6)


def test_serving_moe_call_returns_no_aux():
    _, tcfg = _configs("mixtral-8x22b")
    p = tlm._layer(tlm.init_params(tcfg, seed=0, device="cpu")["blocks"]["p0"], 0)["moe"]
    x = torch.randn(2, 5, tcfg.d_model)
    y = tmoe.moe_ffn(x, p, tcfg)
    y2, aux = tmoe.moe_ffn(x, p, tcfg, with_aux=True)
    assert isinstance(y, torch.Tensor) and torch.equal(y, y2) and aux.ndim == 0


def test_train_forward_refuses_a_vlm_without_its_image():
    _, tcfg = _configs("llama-3.2-vision-11b")
    tparams = tlm.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="img"):
        tlm.train_forward(tparams, torch.zeros(1, 4, dtype=torch.long), tcfg)
