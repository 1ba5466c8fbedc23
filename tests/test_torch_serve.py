"""Port parity at the slice's end: ``ServingEngine.serve`` (continuous
batching over the paged SECDED KV cache) against the reference's on the tiny
config, for a plain engine, an inline single-rail engine and a multi-rail
engine walking its `kv` rail; and, within the port, paged serve against
dense ``generate`` and shared prefixes against private pages.

Undervolted cases hand both packages the same numpy fault masks (the
reference's threefry stream cannot be reproduced by a torch generator). The
masks flip mantissa bits of the f32 payload words and check bits only, so no
stored value becomes inf or NaN; every logit of the port's runs is checked
finite, and every token is compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from conftest import tiny_cfg
from repro.core import kvpages as jkv
from repro.models import lm as jlm
from repro.serving.engine import ProtectionConfig as JProt
from repro.serving.engine import RailsConfig as JRails
from repro.serving.engine import ReliabilityConfig as JRel
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.core import controller as tctl
from repro_torch.core import faultsim as tfs
from repro_torch.models import base as tbase
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as teng

MAX_LEN = 32
PT = 4  # tokens per page
RNG = np.random.default_rng(0)
PROMPTS = RNG.integers(0, 128, (6, 12)).astype(np.int32)
PREFIX = RNG.integers(0, 128, 2 * PT).astype(np.int32)  # a shared two-page prefix
MIXED = [(PROMPTS[i][: 3 + i], 3 + (2 * i) % 7) for i in range(6)]
SHARED = [(np.concatenate([PREFIX, PROMPTS[i][: 1 + i % 3]]), 4 + i % 3) for i in range(6)]


def _port_cfg(cfg, **kw):
    return tbase.ModelConfig(
        name=cfg.name, family=cfg.family, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab,
        head_dim=cfg.head_dim, **kw,
    )


@pytest.fixture(scope="module")
def models():
    cfg = tiny_cfg()
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), _port_cfg(cfg), device="cpu"
    )
    dcfg = tiny_cfg(n_layers=1)
    dparams = jlm.init_params(dcfg, jax.random.PRNGKey(5))
    tdparams = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, dparams), _port_cfg(dcfg), device="cpu"
    )
    return cfg, params, _port_cfg(cfg), tparams, (dcfg, dparams, _port_cfg(dcfg), tdparams)


RELS = {
    "plain": None,
    "single": dict(rails=dict(multi_rail=False)),
    "multi": dict(rails=dict(multi_rail=True, start_v=0.57)),
    # kv pages under a stronger code than SECDED
    "codecs": dict(rails=dict(multi_rail=True, start_v=0.57),
                   codecs={"attention": "parity65", "mlp": "dected79", "kv": "ileave88"}),
    "dected": dict(rails=dict(multi_rail=False), codecs="dected79"),
}


@pytest.fixture(scope="module")
def engines(models):
    cfg, params, tcfg, tparams, _ = models
    out = {}
    for name, rel in RELS.items():
        jrel = trel = None
        if rel is not None:
            codecs = rel.get("codecs")
            jrel = JRel(platform="vc707", voltage=1.0, mode="inline", rails=JRails(**rel["rails"]),
                        protection=JProt(codecs=codecs))
            trel = teng.ReliabilityConfig(platform="vc707", voltage=1.0, mode="inline",
                                          rails=teng.RailsConfig(**rel["rails"]),
                                          protection=teng.ProtectionConfig(codecs=codecs))
        out[name] = (
            JEngine(cfg, params, rel=jrel, max_len=MAX_LEN),
            teng.ServingEngine(tcfg, tparams, rel=trel, max_len=MAX_LEN, device="cpu"),
        )
    return out


class Masks:
    """The n-th interval draw of either arena gets the same numpy masks:
    per-bit probability ``scale * rate``, data flips on mantissa bits only."""

    MANTISSA = np.uint32((1 << 23) - 1)

    def __init__(self, seed, scale):
        self.seed, self.scale, self.calls = seed, scale, 0

    def draw(self, n, rate, n_check):
        self.calls += 1
        rng = np.random.default_rng((self.seed, self.calls))
        bits = rng.random((64 + n_check, n), dtype=np.float32) < np.float32(rate * self.scale)
        w = (1 << np.arange(32, dtype=np.uint64))[:, None]
        lo = (bits[:32] * w).sum(0).astype(np.uint32) & self.MANTISSA
        hi = (bits[32:64] * w).sum(0).astype(np.uint32) & self.MANTISSA
        chk = (bits[64:] * w[:n_check]).sum(0)
        return lo, hi, chk.astype(np.uint8 if n_check <= 8 else np.uint32)

    def install(self, monkeypatch):
        import jax.numpy as jnp

        port = Masks(self.seed, self.scale)

        def ref_fn(key, m, rate, sigma, n_check=8, burst=None):
            return tuple(jnp.asarray(a) for a in self.draw(m, float(rate), n_check))

        monkeypatch.setattr(jkv, "_device_chunk_masks_jit", lambda: ref_fn)
        monkeypatch.setattr(
            tfs, "interval_masks",
            lambda seed, interval, m, rate, sigma, n_check=8, device=None:
                port.draw(m, rate, n_check),
        )
        return port


@pytest.fixture
def finite_logits(monkeypatch):
    """Records whether every logit the port computes is finite."""
    seen = []
    real = tlm._logits

    def logits(params, hidden, cfg):
        out = real(params, hidden, cfg)
        seen.append(bool(torch.isfinite(out).all()))
        return out

    monkeypatch.setattr(tlm, "_logits", logits)
    return seen


def _stats(s) -> dict:
    return dataclasses.asdict(s)


def _record(r) -> dict:
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(tctl.ControllerRecord)}


def _assert_reports_equal(j, t):
    assert sorted(t.outputs) == sorted(j.outputs)
    for rid in j.outputs:
        np.testing.assert_array_equal(t.outputs[rid], np.asarray(j.outputs[rid]), err_msg=str(rid))
    for f in ("steps", "preemptions", "pages_free_at_end", "prefix_hit_tokens",
              "spec_dispatches", "spec_emitted"):
        assert getattr(t, f) == getattr(j, f), f
    assert _stats(t.kv_stats) == _stats(j.kv_stats)
    assert {r: _stats(s) for r, s in t.request_stats.items()} == {
        r: _stats(s) for r, s in j.request_stats.items()
    }
    assert t.kv_voltages == [float(v) for v in j.kv_voltages]


CASES = {
    "nominal": ("plain", MIXED, dict(n_lanes=2, scrub_interval=2, max_block=4)),
    "preempt": ("plain", MIXED, dict(n_lanes=2, n_pages=5, scrub_interval=2)),
    "share_prefix": ("plain", SHARED, dict(n_lanes=2, share_prefix=True, scrub_interval=2)),
    "speculative": ("plain", MIXED, dict(n_lanes=3, speculative=3, scrub_interval=4)),
    # the reference's two harvest orders against the port's one (deferred)
    "undervolt_overlap": ("single", MIXED, dict(n_lanes=3, kv_voltage=0.55, scrub_overlap=True)),
    "undervolt_serial": ("single", MIXED, dict(n_lanes=3, kv_voltage=0.55, scrub_overlap=False)),
    "undervolt_shared": ("single", SHARED, dict(n_lanes=2, kv_voltage=0.55, share_prefix=True)),
    "walk_kv": ("multi", SHARED, dict(n_lanes=2, walk_kv=True, scrub_interval=2)),
    "undervolt_ileave88": ("codecs", MIXED, dict(n_lanes=3, kv_voltage=0.55)),
    "walk_kv_ileave88": ("codecs", SHARED, dict(n_lanes=2, walk_kv=True, scrub_interval=2)),
    "undervolt_dected79": ("dected", MIXED, dict(n_lanes=3, kv_voltage=0.55, max_block=4)),
}


# denser faults where the kv canary must see a DED, and where a stronger code
# than SECDED must meet uncorrectable words
SCALES = {"walk_kv": 40.0, "walk_kv_ileave88": 150.0, "undervolt_dected79": 40.0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_matches_reference(models, engines, monkeypatch, finite_logits, case):
    engine, reqs, kw = CASES[case]
    jeng, teng_ = engines[engine]
    kw = dict(kw, page_tokens=PT)
    masks = Masks(seed=len(case), scale=SCALES.get(case, 6.0)).install(monkeypatch)
    if kw.get("speculative"):
        dcfg, dparams, tdcfg, tdparams = models[4]
        jk = dict(kw, draft_params=dparams, draft_cfg=dcfg)
        tk = dict(kw, draft_params=tdparams, draft_cfg=tdcfg)
    else:
        jk = tk = kw
    tk = {k: v for k, v in tk.items() if k != "scrub_overlap"}
    j = jeng.serve(reqs, **jk)
    t = teng_.serve(reqs, **tk)
    assert all(finite_logits)
    _assert_reports_equal(j, t)
    if engine != "plain":
        assert masks.calls > 0 and t.kv_stats.corrected > 0
        assert t.kv_stats.detected > 0
        assert teng_.power_report() == jeng.power_report()
        assert _stats(teng_.stats) == _stats(jeng.stats)
    if kw.get("share_prefix"):
        assert t.prefix_hit_tokens > 0
    if kw.get("speculative"):
        assert t.spec_dispatches > 0
    if case == "preempt":
        assert t.preemptions >= 1
    if case.startswith("walk_kv"):
        jr, tr = jeng.controller.rails["kv"], teng_.controller.rails["kv"]
        assert [_record(r) for r in tr.history] == [_record(r) for r in jr.history]
        assert tr.locked
        assert teng_.rails == jeng.rails


def test_paged_serve_equals_dense_generate(engines):
    """Same batch composition, nominal cache: the paged stream's tokens are
    the dense decode loop's, bit for bit."""
    _, eng = engines["single"]
    prompts = PROMPTS[:4, :8]
    dense = eng.generate(prompts, 7)
    rep = eng.serve([(p, 7) for p in prompts], n_lanes=4, page_tokens=PT, scrub_interval=1)
    np.testing.assert_array_equal(np.stack([rep.outputs[i] for i in range(4)]), dense)
    assert rep.kv_stats.words > 0 and rep.kv_stats.clean == rep.kv_stats.words


@pytest.mark.parametrize("engine", ["codecs", "dected"])
def test_paged_serve_equals_dense_generate_under_codecs(engines, engine):
    """kv pages under ileave88 / dected79 and weights refreshed into SECDED
    planes: at nominal the paged stream is still the dense decode loop."""
    _, eng = engines[engine]
    prompts = PROMPTS[:4, :8]
    dense = eng.generate(prompts, 7)
    rep = eng.serve([(p, 7) for p in prompts], n_lanes=4, page_tokens=PT, scrub_interval=1,
                    kv_voltage=1.0)
    np.testing.assert_array_equal(np.stack([rep.outputs[i] for i in range(4)]), dense)
    assert rep.arena.codec_name == ("ileave88" if engine == "codecs" else "dected79")
    assert rep.arena.parity.dtype == torch.int32
    assert rep.kv_stats.words > 0 and rep.kv_stats.clean == rep.kv_stats.words


@pytest.mark.parametrize("n_pages", [None, 9])
def test_shared_serve_equals_private(engines, n_pages):
    _, eng = engines["plain"]
    kw = dict(n_lanes=2, page_tokens=PT, n_pages=n_pages, scrub_interval=2)
    private = eng.serve(SHARED, **kw)
    shared = eng.serve(SHARED, share_prefix=True, **kw)
    assert shared.prefix_hit_tokens > 0
    assert shared.pages_free_at_end == private.pages_free_at_end == shared.arena.n_pages
    for rid, toks in private.outputs.items():
        np.testing.assert_array_equal(shared.outputs[rid], toks)
