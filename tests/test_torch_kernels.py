"""Port parity: the plain versions of the four ported kernels against the
reference kernels (Pallas interpret mode on the CPU). The CUDA kernels are
held against these plain versions in tests/test_torch_gpu.py and
chip_smoke.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ecc as jecc
from repro.core import quantize as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import quantize as tq
from repro_torch.kernels import ecc_matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# float32 sums run in another order than the reference kernel's
MATMUL_RTOL = 1e-4


def _words(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _planes(rng, shape, p):
    """Random clean planes and sparse flip masks (numpy)."""
    lo = rng.integers(0, 2**32, shape, dtype=np.uint32)
    hi = rng.integers(0, 2**32, shape, dtype=np.uint32)
    chk = jecc.encode_np(lo, hi)

    def sparse(bits):
        m = rng.random(shape + (bits,)) < p
        return (m * (1 << np.arange(bits, dtype=np.uint64))).sum(-1)

    return lo, hi, chk, sparse(32).astype(np.uint32), sparse(32).astype(np.uint32), \
        sparse(8).astype(np.uint8)


def _to_torch(lo, hi, chk, mlo, mhi, mchk):
    return (_words(lo), _words(hi), torch.from_numpy(chk), _words(mlo), _words(mhi),
            torch.from_numpy(mchk))


@pytest.mark.parametrize("shape", [(1000,), (37, 29), (3, 8, 64)])
@pytest.mark.parametrize("reencode", [False, True])
def test_inject_scrub_plain_matches_reference(shape, reencode):
    planes = _planes(np.random.default_rng(len(shape)), shape, 0.02)
    j = jops.inject_scrub(*map(jnp.asarray, planes), reencode=reencode)
    t = tops.inject_scrub(*_to_torch(*planes), reencode=reencode)
    np.testing.assert_array_equal(_u32(t[0]), np.asarray(j[0]))
    np.testing.assert_array_equal(_u32(t[1]), np.asarray(j[1]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    assert t[3].dtype == torch.int32 and t[3].shape == (8,)


@pytest.mark.parametrize("n_domains", [1, 3])
def test_inject_scrub_domains_plain_matches_reference(n_domains):
    rng = np.random.default_rng(7)
    planes = _planes(rng, (2051,), 0.03)
    dom = np.sort(rng.integers(0, n_domains, 2051)).astype(np.int32)
    j = jops.inject_scrub_domains(*map(jnp.asarray, planes), jnp.asarray(dom), n_domains)
    t = tops.inject_scrub_domains(*_to_torch(*planes), torch.from_numpy(dom), n_domains)
    for a, b in zip(t[:2], j[:2]):
        np.testing.assert_array_equal(_u32(a), np.asarray(b))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


def test_inject_scrub_domains_plain_drops_out_of_range_ids():
    """A word whose domain id lies outside [0, n_domains) is scrubbed but
    counted in no row, as in the reference."""
    rng = np.random.default_rng(8)
    planes = _planes(rng, (3001,), 0.03)
    ids = np.array([0, -1, 1, 3, 2, 5, 1], np.int32)
    dom = np.repeat(ids, [500, 300, 400, 200, 600, 301, 700]).astype(np.int32)
    j = jops.inject_scrub_domains(*map(jnp.asarray, planes), jnp.asarray(dom), 3)
    t = tops.inject_scrub_domains(*_to_torch(*planes), torch.from_numpy(dom), 3)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    inside = (dom >= 0) & (dom < 3)
    whole = tops.inject_scrub(*_to_torch(*(p[inside] for p in planes)))
    np.testing.assert_array_equal(t[3].numpy().sum(0), whole[3].numpy())


@pytest.mark.parametrize("shape", [(513,), (2, 24, 70)])
def test_decode_plain_matches_reference(shape):
    lo, hi, chk, mlo, mhi, mchk = _planes(np.random.default_rng(3), shape, 0.03)
    flo, fhi, fchk = lo ^ mlo, hi ^ mhi, chk ^ mchk
    j = jops.decode(jnp.asarray(flo), jnp.asarray(fhi), jnp.asarray(fchk))
    t = tops.decode(_words(flo), _words(fhi), torch.from_numpy(fchk))
    np.testing.assert_array_equal(_u32(t[0]), np.asarray(j[0]))
    np.testing.assert_array_equal(_u32(t[1]), np.asarray(j[1]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert t[2].shape == shape


def test_quantize_matches_reference():
    x = np.random.default_rng(0).standard_normal((64, 48)).astype(np.float32)
    # column 5 has scale 1.0 per column, so 2.5 and -3.5 sit on rounding ties
    x[:, 5] = 0.0
    x[:3, 5] = (127.0, 2.5, -3.5)
    for axis in (None, 0, 1):
        jqv, js = jq.quantize(jnp.asarray(x), axis=axis)
        tqv, ts = tq.quantize(torch.from_numpy(x), axis=axis)
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("k,n", [(64, 64), (136, 70), (256, 40)])
def test_pack_planes_and_scales_identical(k, n):
    w = np.random.default_rng(k).standard_normal((k, n)).astype(np.float32)
    j = jops.pack_ecc_weights(jnp.asarray(w))
    t = tops.pack_ecc_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(_u32(t.lo), np.asarray(j.lo))
    np.testing.assert_array_equal(_u32(t.hi), np.asarray(j.hi))
    np.testing.assert_array_equal(t.parity.numpy(), np.asarray(j.parity))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert (t.k, t.n) == (j.k, j.n)
    qw = np.asarray(jq.quantize(jnp.asarray(w), axis=1)[0])
    np.testing.assert_array_equal(tref.unpack_ecc_weights(t.lo, t.hi).numpy(), qw)
    x = np.arange(3 * k, dtype=np.float32).reshape(3, k)
    np.testing.assert_array_equal(
        tops.permute_k(torch.from_numpy(x), k).numpy(), np.asarray(jops.permute_k(x, k))
    )


@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (5, 136, 70), (33, 256, 128)])
def test_ecc_matmul_plain_within_tolerance(m, k, n):
    rng = np.random.default_rng(m)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jw = jops.pack_ecc_weights(jnp.asarray(w))
    # faults: single flips (corrected) in a few words
    mlo = np.zeros(jw.lo.shape, np.uint32)
    mlo.reshape(-1)[rng.choice(mlo.size, 5, replace=False)] = 1 << 7
    jw.lo = jnp.asarray(np.asarray(jw.lo) ^ mlo)
    tw = tops.pack_ecc_weights(torch.from_numpy(w))
    tw.lo = _words(_u32(tw.lo) ^ mlo)
    ref = np.asarray(jops.ecc_matmul(jnp.asarray(x), jw))
    out = tops.ecc_matmul(torch.from_numpy(x), tw).numpy()
    assert out.shape == (m, n)
    assert np.abs(out - ref).max() <= MATMUL_RTOL * np.abs(ref).max()
    # the reference's own oracle agrees too
    oracle = np.asarray(jref.ecc_matmul_ref(x, jw.lo, jw.hi, jw.parity, jw.scale))
    assert np.abs(out - oracle).max() <= MATMUL_RTOL * np.abs(oracle).max()


def test_ecc_matmul_decode_threshold_matches_source():
    """The wrapper's threshold and kernel names are the CUDA source's."""
    src = (Path(tmm.__file__).parent / "csrc" / "ecc_matmul.cu").read_text()
    assert int(re.search(r"kDecodeMaxM = (\d+);", src).group(1)) == tmm.DECODE_MAX_M
    for name in tmm.GLOBAL_KERNELS.values():
        assert re.search(rf"__global__ void __launch_bounds__\([^)]*\) {name}\(", src), name


def test_other_devices_raise():
    lo = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tops.decode(lo, lo.to("meta"), torch.zeros(8, dtype=torch.uint8))
