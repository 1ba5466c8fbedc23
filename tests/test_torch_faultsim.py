"""Port parity: rail model, host fault field and telemetry against the
reference, bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import faultsim as jfs
from repro.core import telemetry as jtel
from repro.core import voltage as jv
from repro_torch.core import faultsim as tfs
from repro_torch.core import telemetry as ttel
from repro_torch.core import voltage as tv


def test_platforms_and_power_model_identical():
    assert set(jv.PLATFORMS) == set(tv.PLATFORMS)
    for name in jv.PLATFORMS:
        assert dataclasses.asdict(jv.PLATFORMS[name]) == dataclasses.asdict(tv.PLATFORMS[name])
    for v in np.linspace(0.5, 1.05, 23):
        for name in jv.PLATFORMS:
            assert jv.PLATFORMS[name].fault_rate(v) == tv.PLATFORMS[name].fault_rate(v)
        for ecc in (False, True):
            assert jv.bram_power(v, ecc) == tv.bram_power(v, ecc)
    assert jv.P_REST_W == tv.P_REST_W
    words = {"attention": 3, "mlp": 5, "embedding": 2}
    volts = {"attention": 0.57, "mlp": 0.6, "embedding": 0.55}
    assert jv.multi_rail_bram_power(volts, words) == tv.multi_rail_bram_power(volts, words)
    assert jv.multi_rail_power_saving(volts, words) == tv.multi_rail_power_saving(volts, words)
    jd = jv.derive_domain_profiles(jv.PLATFORMS["vc707"], ("a", "b"), spread=0.4, seed=3)
    td = tv.derive_domain_profiles(tv.PLATFORMS["vc707"], ("a", "b"), spread=0.4, seed=3)
    assert {k: dataclasses.asdict(p) for k, p in jd.items()} == {
        k: dataclasses.asdict(p) for k, p in td.items()
    }


def _assert_masks_equal(j, t):
    np.testing.assert_array_equal(j.lo, t.lo)
    np.testing.assert_array_equal(j.hi, t.hi)
    np.testing.assert_array_equal(j.parity, t.parity)
    assert t.lo.dtype == np.uint32 and t.parity.dtype == np.uint8


@pytest.mark.parametrize("n_words,chunk", [(1000, 1 << 18), (2500, 1024), (7, 3)])
@pytest.mark.parametrize("v", [0.58, 0.56, 0.54])
def test_fault_field_masks_bit_identical(n_words, chunk, v):
    """Same stream as the reference, across chunk boundaries too."""
    p = "vc707"
    j = jfs.FaultField(jv.PLATFORMS[p], n_words, seed=11, chunk_words=chunk).masks(v)
    t = tfs.FaultField(tv.PLATFORMS[p], n_words, seed=11, chunk_words=chunk).masks(v)
    _assert_masks_equal(j, t)
    np.testing.assert_array_equal(j.flip_counts(), t.flip_counts())


def test_zero_rate_masks_skip_the_draw_and_stay_identical(monkeypatch):
    """At or above V_min the port draws nothing; the reference draws and
    compares u < 0, which is never true: the masks are the same zeros."""
    field = tfs.FaultField(tv.PLATFORMS["vc707"], 3000, seed=5, chunk_words=1024)
    monkeypatch.setattr(field, "chunk_masks", lambda *a: pytest.fail("drew at zero rate"))
    for v in (1.0, 0.7, 0.61):
        t = field.masks(v)
        j = jfs.FaultField(jv.PLATFORMS["vc707"], 3000, seed=5, chunk_words=1024).masks(v)
        _assert_masks_equal(j, t)
        assert not t.lo.any() and not t.hi.any() and not t.parity.any()


def test_gather_masks_threads_and_cache_match_sequential():
    prof = tv.PLATFORMS["vc707"]
    fields = [tfs.FaultField(prof, n, seed=s, chunk_words=512) for s, n in
              ((1, 3000), (2, 100), (3, 1500))]
    volts = [0.55, 0.7, 0.57]
    seq = [tfs.FaultField(prof, f.n_words, seed=f.seed, chunk_words=512).masks(v)
           for f, v in zip(fields, volts)]
    par = tfs.gather_masks(list(zip(fields, volts)), workers=4)
    for a, b in zip(seq, par):
        _assert_masks_equal(a, b)
    again = tfs.gather_masks(list(zip(fields, volts)), workers=4)
    assert all(a is b for a, b in zip(par, again))  # unmoved rails: no draw
    moved = tfs.gather_masks([(fields[0], 0.56)], workers=4)[0]
    _assert_masks_equal(
        jfs.FaultField(jv.PLATFORMS["vc707"], 3000, seed=1, chunk_words=512).masks(0.56), moved
    )


def test_fault_stats_from_decode_and_counters():
    rng = np.random.default_rng(0)
    status = rng.integers(0, 3, 500)
    flips = rng.integers(0, 5, 500)
    j = jtel.FaultStats.from_decode(status, flips)
    t = ttel.FaultStats.from_decode(status, flips)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert ttel.COUNTER_FIELDS == jtel.COUNTER_FIELDS
    np.testing.assert_array_equal(j.counters(), t.counters())
    assert t.to_dict() == j.to_dict() and t.coverage() == j.coverage()
    block = rng.integers(0, 100, (3, 8))
    names, words = ("attention", "mlp", "embedding"), {"attention": 7, "mlp": 9, "embedding": 4}
    jd = jtel.FaultStats.from_counter_matrix(block, names, words)
    td = ttel.FaultStats.from_counter_matrix(block, names, words)
    assert td.domains == jd.domains
    assert dataclasses.asdict(td.total()) == dataclasses.asdict(jd.total())
    jd.accumulate(jd)
    td.accumulate(td)
    for d in names:
        assert dataclasses.asdict(td[d]) == dataclasses.asdict(jd[d])


@pytest.mark.parametrize("n_check", [1, 15, 24])
@pytest.mark.parametrize("v", [0.56, 0.54])
def test_fault_field_masks_bit_identical_per_codec_width(n_check, v):
    """A field with another codec's check bits: 64 + n_check bitplanes, the
    check mask in the codec's dtype, the data masks those of every width."""
    p = tv.PLATFORMS["vc707"]
    j = jfs.FaultField(jv.PLATFORMS["vc707"], 2500, seed=4, chunk_words=1024,
                       n_check=n_check).masks(v)
    t = tfs.FaultField(p, 2500, seed=4, chunk_words=1024, n_check=n_check).masks(v)
    np.testing.assert_array_equal(j.lo, t.lo)
    np.testing.assert_array_equal(j.hi, t.hi)
    np.testing.assert_array_equal(j.parity, t.parity)
    assert t.parity.dtype == j.parity.dtype == (np.uint8 if n_check <= 8 else np.uint32)
    assert int(t.parity.max()) < (1 << n_check)
    np.testing.assert_array_equal(j.flip_counts(), t.flip_counts())
    secded = tfs.FaultField(p, 2500, seed=4, chunk_words=1024).masks(v)
    np.testing.assert_array_equal(secded.lo, t.lo)
    np.testing.assert_array_equal(secded.hi, t.hi)
    field = tfs.FaultField(p, 2500, seed=4, n_check=n_check)
    chk = tfs.device_masks(field, v, torch.device("cpu"))[2]
    assert chk.dtype == (torch.uint8 if n_check <= 8 else torch.int32)
    np.testing.assert_array_equal(chk.numpy().view(t.parity.dtype), field.masks(v).parity)
    zero = tfs.device_masks(field, 1.0, torch.device("cpu"))
    assert zero[2].dtype == chk.dtype and not zero[2].any()
    dl = tfs.interval_masks(3, 1, 4000, 1e-3, 0.5, n_check=n_check, device="cpu")
    assert dl[2].dtype == chk.dtype and int(dl[2].max()) < (1 << n_check)
