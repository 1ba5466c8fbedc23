"""Port parity: SECDED codec tables and plain encode/classify/decode
against the reference codec, bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import codes as jcodes
from repro.codes import secded as jsecded
from repro.core import ecc as jecc
from repro_torch import codes as tcodes
from repro_torch.codes import secded as tsecded
from repro_torch.codes.base import narrow, widen


def _words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shape", [(72, 64), (22, 16)])
def test_hsiao_tables_identical(shape):
    n_bits, n_data = shape
    j = jsecded.build_hsiao(n_data, n_bits - n_data)
    t = tsecded.build_hsiao(n_data, n_bits - n_data)
    for key in ("data_cols", "parity_cols", "mask_lo", "mask_hi", "syndrome_lut", "row_weight"):
        np.testing.assert_array_equal(j[key], t[key], err_msg=key)


def test_codec_luts_identical():
    j, t = jcodes.get("secded72"), tcodes.get("secded72")
    assert (t.name, t.n_check, t.corrects_random, t.detects_random) == (
        j.name, j.n_check, j.corrects_random, j.detects_random
    )
    for key in ("mask_lo", "mask_hi", "lut_status", "lut_flip_lo", "lut_flip_hi",
                "lut_flip_check"):
        np.testing.assert_array_equal(getattr(j, key), getattr(t, key), err_msg=key)
    assert tcodes.names() == ("secded72",)


def test_all_256_syndromes_classify_identically():
    synd = np.arange(256, dtype=np.uint32)
    jflo, jfhi, _, jst = jcodes.get("secded72").classify_jnp(jnp.asarray(synd))
    tflo, tfhi, tst = tcodes.get("secded72").classify(torch.arange(256, dtype=torch.int64))
    np.testing.assert_array_equal(np.asarray(jst), tst.numpy())
    np.testing.assert_array_equal(np.asarray(jflo), tflo.numpy().astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(jfhi), tfhi.numpy().astype(np.uint32))


def test_word_round_trip_is_exact():
    a = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    t = _words(a)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(_u32(narrow(widen(t))), a)
    np.testing.assert_array_equal(widen(t).numpy(), a.astype(np.int64))


@pytest.mark.parametrize("n", [1, 517, 4096])
def test_encode_decode_match_reference(n):
    rng = np.random.default_rng(n)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    check = jecc.encode_np(lo, hi)
    codec = tcodes.get("secded72")
    np.testing.assert_array_equal(codec.encode(_words(lo), _words(hi)).numpy(), check)
    # flip 0, 1 or 2 random bits of the 72-bit word
    flips = rng.integers(0, 3, n)
    flo, fhi, fch = lo.copy(), hi.copy(), check.copy()
    for i in range(n):
        for b in rng.choice(72, flips[i], replace=False):
            if b < 32:
                flo[i] ^= np.uint32(1 << b)
            elif b < 64:
                fhi[i] ^= np.uint32(1 << (b - 32))
            else:
                fch[i] ^= np.uint8(1 << (b - 64))
    jlo, jhi, jst = jecc.decode(jnp.asarray(flo), jnp.asarray(fhi), jnp.asarray(fch))
    tlo, thi, tst = codec.decode(_words(flo), _words(fhi), torch.from_numpy(fch))
    np.testing.assert_array_equal(_u32(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(_u32(thi), np.asarray(jhi))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    # every single flip corrected, every double detected
    np.testing.assert_array_equal(tst.numpy(), flips)


def test_kernel_table_layout():
    codec = tcodes.get("secded72")
    raw = codec.kernel_tables(torch.device("cpu")).numpy()
    assert raw.size == 2368
    words = raw[:2112].view(np.uint32)
    np.testing.assert_array_equal(words[:8], codec.mask_lo)
    np.testing.assert_array_equal(words[8:16], codec.mask_hi)
    np.testing.assert_array_equal(words[16:272], codec.lut_flip_lo)
    np.testing.assert_array_equal(words[272:528], codec.lut_flip_hi)
    np.testing.assert_array_equal(raw[2112:], codec.lut_status.astype(np.uint8))
