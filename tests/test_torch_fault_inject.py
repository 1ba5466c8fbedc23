"""Port parity of the read-time fault injection (B7), the scrub pass and the
naive ECC read path against the reference (Pallas interpret mode on the
CPU). The CUDA kernel is held against the plain version in
tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ecc as jecc
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

# float32 sums run in another order than the reference's
MATMUL_RTOL = 1e-4


def _words(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _planes(rng, shape, p):
    """Random clean planes and sparse flip masks (numpy)."""
    lo = rng.integers(0, 2**32, shape, dtype=np.uint32)
    hi = rng.integers(0, 2**32, shape, dtype=np.uint32)
    chk = jecc.encode_np(lo, hi)

    def sparse(bits):
        m = rng.random(tuple(shape) + (bits,)) < p
        return (m * (1 << np.arange(bits, dtype=np.uint64))).sum(-1)

    return (lo, hi, np.asarray(chk), sparse(32).astype(np.uint32),
            sparse(32).astype(np.uint32), sparse(8).astype(np.uint8))


def _to_torch(lo, hi, chk, mlo, mhi, mchk):
    return (_words(lo), _words(hi), torch.from_numpy(chk), _words(mlo), _words(mhi),
            torch.from_numpy(mchk))


@pytest.mark.parametrize("shape", [(1,), (7,), (513,), (4099,), (37, 29), (3, 8, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_inject_matches_reference(shape):
    planes = _planes(np.random.default_rng(sum(shape)), shape, 0.05)
    j = jops.inject(*map(jnp.asarray, planes))
    t = tops.inject(*_to_torch(*planes))
    for a in t:
        assert tuple(a.shape) == tuple(shape)
    np.testing.assert_array_equal(_u32(t[0]), np.asarray(j[0]))
    np.testing.assert_array_equal(_u32(t[1]), np.asarray(j[1]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert t[2].dtype == torch.uint8


def test_inject_with_zero_masks_is_identity():
    lo, hi, chk, *_ = _to_torch(*_planes(np.random.default_rng(3), (300,), 0.0))
    out = tops.inject(lo, hi, chk, torch.zeros_like(lo), torch.zeros_like(hi),
                      torch.zeros_like(chk))
    assert all(torch.equal(a, b) for a, b in zip(out, (lo, hi, chk)))


def _ecc_weight(rng, k, n, p):
    """A packed (K, N) weight in both packages, with flips of rate p."""
    w = rng.standard_normal((k, n)).astype(np.float32)
    jw = jops.pack_ecc_weights(jnp.asarray(w))
    shape = jw.lo.shape
    m = _planes(rng, shape, p)[3:]
    lo, hi, par = jops.inject(jw.lo, jw.hi, jw.parity, *map(jnp.asarray, m))
    jw = jops.EccWeight(lo, hi, par, jw.scale, k, n, True)
    tw = tops.EccWeight(_words(np.asarray(lo)), _words(np.asarray(hi)),
                        torch.from_numpy(np.array(par)),
                        torch.from_numpy(np.array(jw.scale)), k, n)
    return jw, tw


@pytest.mark.parametrize("k,n,p", [(64, 64, 0.0), (136, 70, 0.01), (256, 40, 0.03)])
def test_scrub_matches_reference(k, n, p):
    jw, tw = _ecc_weight(np.random.default_rng(k), k, n, p)
    np.testing.assert_array_equal(tops.scrub(tw).numpy(), np.asarray(jops.scrub(jw)))


@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (5, 136, 70), (33, 256, 128)])
def test_ecc_matmul_naive_matches_reference_and_fused(m, k, n):
    rng = np.random.default_rng(m + k)
    jw, tw = _ecc_weight(rng, k, n, 0.01)
    x = rng.standard_normal((m, k)).astype(np.float32)
    j = np.asarray(jops.ecc_matmul(jnp.asarray(x), jw, fuse=False))
    naive = tops.ecc_matmul(torch.from_numpy(x), tw, fuse=False).numpy()
    fused = tops.ecc_matmul(torch.from_numpy(x), tw, fuse=True).numpy()
    tol = MATMUL_RTOL * float(np.abs(j).max())
    assert naive.shape == fused.shape == (m, n)
    np.testing.assert_allclose(naive, j, rtol=0, atol=tol)
    np.testing.assert_allclose(fused, naive, rtol=0, atol=tol)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's own wrapper launches on the card only; ``ops.inject``
    takes the plain version for CPU tensors before reaching it."""
    from repro_torch.kernels import fault_inject as tfi

    lo, hi, chk, mlo, mhi, mchk = _to_torch(*_planes(np.random.default_rng(1), (9,), 0.1))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tfi.inject(lo, hi, chk, mlo, mhi, mchk)
    with pytest.raises(ValueError, match="several devices"):
        tops.inject(lo, hi, chk, mlo.to("meta"), mhi, mchk)
