"""``mask_source="device"`` through the port's plane store, serving engine
and Fig. 3 MLP on the CPU (the fault-field kernel's plain version),
mirroring the reference's device-mask tests
(tests/test_engine_batched.py::test_device_mask_source_serves and the
device-mask multi-rail autotune of tests/test_multirail.py). The device
streams equal the reference's in distribution only, so faulty states are
held to the model's properties (FIP, DED-free locks, every word counted);
fault-free states are held to the reference bit for bit."""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

import jax

from conftest import tiny_cfg
from repro.models import lm as jlm
from repro.serving.engine import FaultModelConfig as JFaults
from repro.serving.engine import ReliabilityConfig as JRel
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import shapes as tshapes
from repro_torch.core import planestore as tps
from repro_torch.core import voltage as tv
from repro_torch.core.nn_accel import EccMLP as TMLP
from repro_torch.kernels import ops as tops
from repro_torch.models import base as tbase
from repro_torch.serving import engine as teng

PROMPTS = np.random.default_rng(0).integers(0, 128, (2, 8)).astype(np.int32)
KEYS = (
    "['blocks']['p0']['attn']['wq']",
    "['blocks']['p0']['mlp']['w1']",
    "['embed']",
)
MIX = {"attention": "parity65", "mlp": "dected79", "embedding": "secded72"}


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
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def leaves():
    rng = np.random.default_rng(0)
    ws = [rng.standard_normal(s).astype(np.float32) for s in ((64, 96), (128, 64), (256, 64))]
    return [tops.pack_ecc_weights(torch.from_numpy(w)) for w in ws]


def _store(leaves, mask_source="device", **kw):
    return tps.PlaneStore(leaves, KEYS, tv.PLATFORMS["vc707"], seed=3, mask_source=mask_source,
                          device="cpu", **kw)


def _planes(faulty):
    return [(w.lo, w.hi, w.parity) for w in faulty]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))


# -- the serving engine ----------------------------------------------------------


def test_device_mask_source_serves(models):
    cfg, params, tcfg, tparams = models
    rel = teng.ReliabilityConfig(platform="vc707", voltage=0.55, mode="inline",
                                 fault_model=teng.FaultModelConfig(mask_source="device"))
    eng = teng.ServingEngine(tcfg, tparams, rel=rel, max_len=48, device="cpu")
    assert eng._store.mask_source == "device"
    assert eng.stats.words == eng._store.n_words > 0
    assert eng.stats.faulty_bits > 0  # 0.55 V is well below the guardband
    out = eng.generate(PROMPTS, 4)
    assert out.shape == (2, 4)
    # fault-free, the device-mask engine is the reference's, token for token
    eng.set_voltage(1.0)
    jrel = JRel(platform="vc707", voltage=1.0, mode="inline",
                fault_model=JFaults(mask_source="device"))
    jeng = JEngine(cfg, params, rel=jrel, max_len=48)
    np.testing.assert_array_equal(eng.generate(PROMPTS, 4), jeng.generate(PROMPTS, 4))


def test_engine_multirail_device_autotune_locks_ded_free(models):
    _, _, tcfg, tparams = models
    eng = teng.ServingEngine(
        tcfg, tparams,
        rel=teng.ReliabilityConfig(
            platform="vc707", mode="inline", rails=teng.RailsConfig(multi_rail=True,
                                                                    start_v=0.62),
            fault_model=teng.FaultModelConfig(mask_source="device")),
        max_len=32, device="cpu",
    )
    volts, history = eng.autotune_voltage()
    prof = tv.PLATFORMS["vc707"]
    assert all(prof.v_crash <= v <= prof.v_min for v in volts.values())
    assert all(len(history[d]) > 0 for d in volts)
    out = eng.generate(PROMPTS, 6)
    assert out.shape == (2, 6)
    # the locked schedule was DED-free on its final scrub
    assert all(eng._last_scrub[d].detected == 0 for d in eng._store.domains)
    # cumulative per-domain telemetry accounts every scrubbed word
    assert eng.rail_stats.total().words == eng.stats.words


@pytest.mark.parametrize("kw", [
    {"mode": "domain", "fault_model": teng.FaultModelConfig(mask_source="device")},
    {"fault_model": teng.FaultModelConfig(mask_source="device", batched=False)},
    {"fault_model": teng.FaultModelConfig(mask_source="device"),
     "rails": teng.RailsConfig(multi_rail=True)},
])
def test_validate_accepts_device_masks(kw):
    """Wherever the reference's ``validate`` accepts them (domain mode and
    the per-leaf path keep host fields)."""
    teng.ReliabilityConfig(**{"mode": "inline", **kw}).validate()


def test_validate_rejects_an_unknown_mask_source():
    with pytest.raises(teng.ReliabilityConfigError, match="mask_source"):
        teng.ReliabilityConfig(
            mode="inline", fault_model=teng.FaultModelConfig(mask_source="disk")).validate()


# -- the plane store -------------------------------------------------------------


@pytest.mark.parametrize("codecs", [None, MIX], ids=["secded72", "codec_mix"])
def test_store_set_rails_uniform_equals_set_voltage(leaves, codecs):
    store = _store(leaves, domain_key=tshapes.domain_of, codecs=codecs)
    for v in (0.56, 0.54):
        fv, sv = store.set_voltage(v)
        fr, sr = store.set_rails({d: v for d in store.domains})
        assert _equal(_planes(fv), _planes(fr)), v
        assert dataclasses.asdict(sr.total()) == dataclasses.asdict(sv)
        assert sv.faulty_bits > 0


def test_store_async_harvest_equals_sync(leaves):
    store = _store(leaves, domain_key=tshapes.domain_of, codecs=MIX)
    rails = {"attention": 0.55, "mlp": 0.57, "embedding": 0.54}
    fa, pending = store.set_rails_async(rails)
    fs, stats = store.set_rails(rails)
    assert _equal(_planes(fa), _planes(fs))
    assert pending.harvest() == stats
    fa, pending = store.set_voltage_async(0.55, ecc=False)
    fs, stats = store.set_voltage(0.55, ecc=False)
    assert _equal(_planes(fa), _planes(fs))
    assert pending.harvest() == stats


def test_store_groups_keep_the_reference_seeds(leaves):
    single = _store(leaves)
    (g,) = single.groups
    assert g.field.seed == 3 and g.field.n_words == g.n_words == single.n_words
    mixed = _store(leaves, domain_key=tshapes.domain_of, codecs=MIX)
    for g in mixed.groups:
        assert g.field.seed == (3 ^ zlib.crc32(g.name.encode())) & 0x7FFFFFFF
        assert g.field.n_check == g.codec.n_check
    assert all(g.field is None for g in _store(leaves, mask_source="host").groups)


def test_store_draws_only_groups_below_v_min(leaves, monkeypatch):
    store = _store(leaves, domain_key=tshapes.domain_of, codecs=MIX)
    calls = []
    real = tops.fault_field
    monkeypatch.setattr(tops, "fault_field", lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    _, stats = store.set_rails({d: 1.0 for d in store.domains})
    assert calls == [] and stats.total().faulty_bits == 0
    store.set_rails({"attention": 1.0, "mlp": 0.55, "embedding": 1.0})
    assert calls == [15]  # only the dected79 group drew
    calls.clear()
    _, s = _store(leaves).set_voltage(0.8)
    assert calls == [] and s.faulty_bits == 0


def test_store_device_masks_hold_fip(leaves):
    store = _store(leaves, domain_key=tshapes.domain_of, codecs=MIX)
    clean = [tuple(x.clone() for x in m) for m in store.group_masks(1.0)]
    prev = None
    for v in (0.58, 0.56, 0.54):
        cur = store.group_masks({d: v for d in store.domains})
        if prev is not None:
            for p, c in zip(prev, cur):
                assert all(not (a & ~b).any() for a, b in zip(p, c)), v
        prev = cur
    assert not any(x.any() for m in clean for x in m)


# -- the Fig. 3 MLP --------------------------------------------------------------


def test_eccmlp_device_masks_store_and_step():
    sizes = (64, 32, 10)
    dev = TMLP(sizes, platform="vc707", seed=7, mask_source="device", device="cpu")
    host = TMLP(sizes, platform="vc707", seed=7, device="cpu")
    dev.store()
    host.store()
    assert dev._store.mask_source == "device"
    # at nominal, no faults: the planes are the host-mask MLP's
    for a, b in zip(dev.layers, host.layers):
        assert _equal([(a.faulty.lo, a.faulty.hi, a.faulty.parity)],
                      [(b.faulty.lo, b.faulty.hi, b.faulty.parity)])
    # the counters obey FIP down the sweep
    flips = []
    for v in (0.60, 0.57, 0.55, 0.54):
        dev.set_voltage(v)
        assert dev.stats.words == sum(l.enc.lo.numel() for l in dev.layers)
        flips.append(dev.stats.faulty_bits)
    assert flips == sorted(flips) and flips[-1] > 0
    # the per-leaf path keeps its host fields: equal to the host MLP's
    dev.set_voltage(0.55, batched=False)
    host.set_voltage(0.55, batched=False)
    assert dev.stats == host.stats
    assert dev.predict(np.ones((3, 64), np.float32)).shape == (3,)
