"""Port parity of the paper's NN accelerator (``EccMLP``, Fig. 3): the
synthetic-MNIST generator and config, stored planes, batched and per-leaf
voltage steps, logits, predictions, power and float training, against the
reference with its weights carried across as numpy arrays."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import paper_nn as jpaper
from repro.core.nn_accel import EccMLP as JMLP
from repro.data import mnist as jmnist
from repro.kernels import ops as jops
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import paper_nn as tpaper
from repro_torch.core.nn_accel import EccMLP as TMLP
from repro_torch.data import mnist as tmnist

SIZES = (64, 32, 10)
# float32 sums run in another order than the reference's Pallas matmul
LOGIT_RTOL = 1e-4
# 40 float32 SGD steps in two frameworks: relative to the largest value
TRAIN_RTOL = 1e-4
STEPS = [(0.56, True), (0.55, False), (0.54, True)]


@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_dataset_byte_identical(split):
    jx, jy = jmnist.make_dataset(300, seed=2, split=split)
    tx, ty = tmnist.make_dataset(300, seed=2, split=split)
    assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
    assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()


def test_paper_nn_configs_equal():
    for fn in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(tpaper, fn)()) == dataclasses.asdict(
            getattr(jpaper, fn)())
    assert dataclasses.asdict(tget_config("paper-nn")) == dataclasses.asdict(
        jget_config("paper-nn"))


def _np_params(mlp):
    return [(np.asarray(l.w), np.asarray(l.b)) for l in mlp.layers]


def _pair(seed=3):
    j = JMLP(SIZES, platform="vc707", seed=seed)
    t = TMLP(SIZES, platform="vc707", seed=seed, device="cpu")
    t.load_params(_np_params(j))
    j.store()
    t.store()
    return j, t


def _bytes(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _planes(mlp):
    """The faulty planes of every layer as bytes (int32 and uint32 bit
    patterns compare equal)."""
    return [tuple(_bytes(p) for p in (l.faulty.lo, l.faulty.hi, l.faulty.parity))
            for l in mlp.layers]


def _same_planes(a, b):
    for la, lb in zip(a, b):
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_store_planes_bit_identical(pair):
    j, t = pair
    for jl, tl in zip(j.layers, t.layers):
        np.testing.assert_array_equal(tl.enc.lo.numpy().view(np.uint32), np.asarray(jl.enc.lo))
        np.testing.assert_array_equal(tl.enc.hi.numpy().view(np.uint32), np.asarray(jl.enc.hi))
        np.testing.assert_array_equal(tl.enc.parity.numpy(), np.asarray(jl.enc.parity))
        np.testing.assert_array_equal(tl.enc.scale.numpy(), np.asarray(jl.enc.scale))
    _same_planes(_planes(t), _planes(j))  # nominal view after store()


@pytest.mark.parametrize("v,ecc", STEPS)
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "per_leaf"])
def test_set_voltage_bit_identical(pair, v, ecc, batched):
    j, t = pair
    j.set_voltage(v, ecc=ecc, batched=batched)
    t.set_voltage(v, ecc=ecc, batched=batched)
    _same_planes(_planes(t), _planes(j))
    np.testing.assert_array_equal(t.stats.counters(), j.stats.counters())
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.stats.faulty_words > 0
    assert t.power_w() == j.power_w() and t.bram_power_w() == j.bram_power_w()


@pytest.mark.parametrize("v,ecc", STEPS)
def test_per_leaf_equals_batched(v, ecc):
    _, t = _pair(seed=4)
    t.set_voltage(v, ecc=ecc, batched=False)
    planes, counters = _planes(t), t.stats.counters()
    t.set_voltage(v, ecc=ecc, batched=True)
    _same_planes(_planes(t), planes)
    np.testing.assert_array_equal(t.stats.counters(), counters)


def _ref_logits(mlp, xs, fuse):
    h = jnp.asarray(xs)
    for i, l in enumerate(mlp.layers):
        h = jops.ecc_matmul(h, l.faulty, fuse=fuse) + l.b
        if i < len(mlp.sizes) - 2:
            h = jax.nn.relu(h)
    return np.asarray(h)


@pytest.mark.parametrize("v,ecc", [(1.0, True)] + STEPS)
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "naive"])
def test_logits_and_predictions(v, ecc, fuse):
    j, t = _pair(seed=5)
    xs = np.random.default_rng(0).standard_normal((200, SIZES[0])).astype(np.float32)
    j.set_voltage(v, ecc=ecc)
    t.set_voltage(v, ecc=ecc)
    jl = _ref_logits(j, xs, fuse)
    tl = t.logits(xs, fuse=fuse).numpy()
    tol = LOGIT_RTOL * float(np.abs(jl).max())
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol)
    top2 = np.sort(jl, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > tol
    assert clear.mean() > 0.9
    jp, tp = j.predict(xs, fuse=fuse), t.predict(xs, fuse=fuse)
    np.testing.assert_array_equal(tp[clear], jp[clear])
    ys = jp.copy()
    ys[::3] = (ys[::3] + 1) % SIZES[-1]
    xc, yc = xs[clear], ys[clear]
    assert t.error_rate(xc, yc, fuse=fuse) == j.error_rate(xc, yc, fuse=fuse)


def test_power_equal_across_voltages(pair):
    j, t = pair
    for v in (1.0, 0.61, 0.58, 0.54):
        for ecc in (True, False):
            j.voltage, j.ecc_enabled = v, ecc
            t.voltage, t.ecc_enabled = v, ecc
            assert t.power_w() == j.power_w()
            assert t.bram_power_w() == j.bram_power_w()


def test_train_matches_reference():
    xs, ys = jmnist.make_dataset(512, seed=1, split="train")
    xs = xs[:, : SIZES[0]]
    j = JMLP(SIZES, platform="vc707", seed=7)
    t = TMLP(SIZES, platform="vc707", seed=7, device="cpu")
    t.load_params(_np_params(j))
    jloss = j.train(xs, ys, steps=40, batch=64, lr=3e-3, seed=2)
    tloss = t.train(xs, ys, steps=40, batch=64, lr=3e-3, seed=2)
    assert abs(tloss - jloss) <= TRAIN_RTOL * abs(jloss)
    for (jw, jb), (tw, tb) in zip(_np_params(j), _np_params(t)):
        np.testing.assert_allclose(tw, jw, rtol=0, atol=TRAIN_RTOL * float(np.abs(jw).max()))
        np.testing.assert_allclose(tb, jb, rtol=0, atol=TRAIN_RTOL * float(np.abs(jw).max()))
    # train() ends in store() and a nominal step over the new planes
    assert t.stats.words == sum(l.enc.lo.numel() for l in t.layers) > 0


def test_device_masks_are_rejected():
    """Device masks are no longer rejected: the MLP hands them to its plane
    store, and only an unknown source is refused."""
    t = TMLP(SIZES, mask_source="device", device="cpu")
    t.store()
    assert t._store.mask_source == "device"
    assert all(g.field is not None for g in t._store.groups)
    t.set_voltage(0.54)
    assert t.stats.words == sum(l.enc.lo.numel() for l in t.layers) and t.stats.faulty_bits > 0
    with pytest.raises(ValueError, match="disk"):
        TMLP(SIZES, mask_source="disk", device="cpu")


def test_mlp_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMLP(SIZES)
