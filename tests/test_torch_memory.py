"""Port parity of the memory domain: raw-bit word packing of every dtype and
``EccMemoryDomain`` reads at nominal and undervolted rails, with ECC on and
off, against the reference (same numpy fault field, so bit for bit)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import PLATFORMS as JPLATFORMS
from repro.core import EccMemoryDomain as JDomain
from repro.core import FaultStats as JStats
from repro.core import UndervoltController as JController
from repro.core import quantize as jq
from repro_torch.core import quantize as tq
from repro_torch.core.controller import UndervoltController as TController
from repro_torch.core.memory import EccMemoryDomain as TDomain
from repro_torch.core.telemetry import FaultStats as TStats
from repro_torch.core.voltage import PLATFORMS as TPLATFORMS

# (numpy dtype of the bits, torch dtype, reference dtype)
DTYPES = {
    "float32": (np.float32, torch.float32, np.float32),
    "bfloat16": (np.int16, torch.bfloat16, jnp.bfloat16),
    "int8": (np.int8, torch.int8, np.int8),
    "int32": (np.int32, torch.int32, np.int32),
    "float64": (np.float64, torch.float64, np.float64),
    "int64": (np.int64, torch.int64, np.int64),
}


def _arrays(name, shape, seed=0):
    """The same bits as (reference numpy array, port tensor)."""
    np_dt, t_dt, j_dt = DTYPES[name]
    rng = np.random.default_rng(seed)
    if np.dtype(np_dt).kind == "f":
        bits = (rng.standard_normal(shape) * 3).astype(np_dt)
    else:
        info = np.iinfo(np_dt)
        bits = rng.integers(info.min, info.max, shape, dtype=np_dt, endpoint=True)
    j = bits.view(j_dt)
    return j, torch.from_numpy(bits.copy()).view(t_dt)


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", [(3,), (5, 7), (1,), (2, 3, 5)], ids=lambda s: "x".join(map(str, s)))
def test_words_round_trip_matches_reference(name, shape):
    j, t = _arrays(name, shape, seed=len(shape))
    jlo, jhi, jn = jq.array_to_words_np(j)
    tlo, thi, tn = tq.array_to_words(t)
    assert tn == jn == j.nbytes
    np.testing.assert_array_equal(tlo.numpy().view(np.uint32), jlo)
    np.testing.assert_array_equal(thi.numpy().view(np.uint32), jhi)
    back = tq.words_to_array(tlo, thi, tn, tuple(t.shape), t.dtype)
    assert back.dtype == t.dtype and tuple(back.shape) == tuple(shape)
    jback = jq.words_to_array(jnp.asarray(jlo), jnp.asarray(jhi), jn, j.shape, j.dtype)
    np.testing.assert_array_equal(_bytes(back), _bytes(t))
    np.testing.assert_array_equal(_bytes(back), _bytes(jback))


def test_dequantize_matches_reference():
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, (9, 5), dtype=np.int8)
    s = rng.random(5).astype(np.float32)
    j = np.asarray(jq.dequantize(jnp.asarray(q), jnp.asarray(s)))
    t = tq.dequantize(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(t, j)


def _tree(seed=0):
    """A nested tree of mixed dtypes, large enough to fault at 0.56 V."""
    leaves = {
        ("a",): _arrays("float32", (96, 130), seed),
        ("b", "c"): _arrays("int8", (1001,), seed + 1),
        ("b", "d"): _arrays("bfloat16", (67, 45), seed + 2),
        ("e",): _arrays("float64", (33, 17), seed + 3),
    }
    j = {"a": leaves[("a",)][0], "b": {"c": leaves[("b", "c")][0], "d": leaves[("b", "d")][0]},
         "e": leaves[("e",)][0]}
    t = {"a": leaves[("a",)][1], "b": {"c": leaves[("b", "c")][1], "d": leaves[("b", "d")][1]},
         "e": leaves[("e",)][1]}
    return j, t


def _flat_bytes(tree) -> list:
    if isinstance(tree, dict):
        return [b for k in sorted(tree) for b in _flat_bytes(tree[k])]
    return [_bytes(tree)]


@pytest.fixture(scope="module", params=[True, False], ids=["ecc", "no_ecc"])
def domains(request):
    j_tree, t_tree = _tree()
    jd = JDomain("vc707", seed=5, ecc_enabled=request.param)
    td = TDomain("vc707", seed=5, ecc_enabled=request.param, device="cpu")
    jd.write_pytree("w", j_tree)
    td.write_pytree("w", t_tree)
    jd.write("solo", j_tree["b"]["d"])
    td.write("solo", t_tree["b"]["d"])
    return jd, td, j_tree, t_tree


def test_domain_names_and_planes_equal(domains):
    jd, td, _, _ = domains
    assert td.names() == jd.names()
    for name in jd.names():
        je, te = jd.entry(name), td.entry(name)
        np.testing.assert_array_equal(te.lo.numpy().view(np.uint32), je.lo)
        np.testing.assert_array_equal(te.hi.numpy().view(np.uint32), je.hi)
        np.testing.assert_array_equal(te.parity.numpy(), je.parity)
        assert te.field.seed == je.field.seed and te.nbytes == je.nbytes


@pytest.mark.parametrize("v", [1.0, 0.56, 0.54])
def test_read_pytree_bit_identical(domains, v):
    jd, td, j_tree, t_tree = domains
    jd.set_voltage(v)
    td.set_voltage(v)
    jout, jst = jd.read_pytree("w", j_tree)
    tout, tst = td.read_pytree("w", t_tree)
    for a, b in zip(_flat_bytes(tout), _flat_bytes(jout)):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    if v < 0.6:
        assert tst.faulty_words > 0
    if v == 1.0:
        for a, b in zip(_flat_bytes(tout), _flat_bytes(t_tree)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("v", [0.56, 0.54])
@pytest.mark.parametrize("at_rail", [True, False], ids=["rail", "arg"])
def test_read_one_array_bit_identical(domains, v, at_rail):
    """One array read at the rail's voltage, or at a ``voltage=`` argument."""
    jd, td, _, _ = domains
    if at_rail:
        jd.set_voltage(v)
        td.set_voltage(v)
    kw = {} if at_rail else {"voltage": v}
    jarr, jst = jd.read("solo", **kw)
    tarr, tst = td.read("solo", **kw)
    assert tarr.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bytes(tarr), _bytes(jarr))
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)


def test_domain_stats_accumulate_equal(domains):
    jd, td, _, _ = domains
    assert dataclasses.asdict(td.stats) == dataclasses.asdict(jd.stats)


def test_set_voltage_below_crash_raises():
    td = TDomain("vc707", device="cpu")
    jd = JDomain("vc707")
    with pytest.raises(RuntimeError, match="rail collapsed"):
        td.set_voltage(0.53)
    with pytest.raises(RuntimeError, match="rail collapsed"):
        jd.set_voltage(0.53)
    td.set_voltage(0.54)
    assert td.voltage == 0.54


def test_controller_locks_at_the_same_voltage():
    """The reference's controller-lock test run in both packages."""
    w = np.random.default_rng(1).standard_normal((256, 256)).astype(np.float32)
    locks = []
    for dom, ctrl, stats_cls in (
        (JDomain("vc707", seed=9), JController(JPLATFORMS["vc707"], step_v=0.01), JStats),
        (TDomain("vc707", seed=9, device="cpu"),
         TController(TPLATFORMS["vc707"], step_v=0.01), TStats),
    ):
        dom.write("w", w)
        while not ctrl.locked:
            dom.stats = stats_cls()
            _, stats = dom.read("w", voltage=ctrl.voltage)
            ctrl.update(stats)
        _, stats = dom.read("w", voltage=ctrl.voltage)
        assert stats.detected == 0
        locks.append((ctrl.voltage, [(r.voltage, r.detected, r.action) for r in ctrl.history]))
    assert locks[1] == locks[0]
    prof = TPLATFORMS["vc707"]
    assert prof.v_crash <= locks[1][0] <= prof.v_min


def test_domain_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDomain("vc707")
