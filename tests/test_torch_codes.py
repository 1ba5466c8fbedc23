"""Port parity: the four codecs' tables and plain encode/classify/decode
against the reference codecs, bit for bit, and the kernel-table layouts."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import codes as jcodes
from repro.codes import secded as jsecded
from repro.core import ecc as jecc
from repro.kernels import ops as jops
from repro_torch import codes as tcodes
from repro_torch.codes import interleaved as tileave
from repro_torch.codes import secded as tsecded
from repro_torch.codes.base import narrow, widen

ALL = ("parity65", "secded72", "ileave88", "dected79")
DENSE = ("parity65", "secded72", "dected79")
CODEC_CUH = (
    Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/codec.cuh"
).read_text()


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
    assert tcodes.names() == ("parity65", "secded72", "ileave88", "dected79")


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


def test_registry_order_and_properties_identical():
    assert tcodes.names() == jcodes.names() == ALL
    for name in ALL:
        j, t = jcodes.get(name), tcodes.get(name)
        for attr in ("name", "n_check", "corrects_random", "detects_random", "corrects_burst",
                     "sure_correct", "check_dtype", "exact_tallies"):
            assert getattr(t, attr) == getattr(j, attr), (name, attr)
        assert t.check_torch_dtype == (torch.uint8 if t.n_check <= 8 else torch.int32)
        np.testing.assert_array_equal(t.mask_lo, j.mask_lo)
        np.testing.assert_array_equal(t.mask_hi, j.mask_hi)


@pytest.mark.parametrize("name", DENSE)
def test_dense_tables_identical(name):
    j, t = jcodes.get(name), tcodes.get(name)
    for key in ("lut_status", "lut_flip_lo", "lut_flip_hi", "lut_flip_check"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key), err_msg=key)


def test_ileave88_sub_table_identical():
    j, t = jcodes.get("ileave88"), tcodes.get("ileave88")
    assert t.lut_status is None and j.lut_status is None  # no 2^24 table
    np.testing.assert_array_equal(t.sub_lut, jsecded.build_hsiao(16, 6)["syndrome_lut"])
    np.testing.assert_array_equal(t.sub_lut, tsecded.build_hsiao(16, 6)["syndrome_lut"])


def _classify_both(name, synd: np.ndarray):
    jf = jcodes.get(name).classify_jnp(jnp.asarray(synd.astype(np.uint32)))
    tf = tcodes.get(name).classify(torch.from_numpy(synd.astype(np.int64)))
    for a, b in ((jf[0], tf[0]), (jf[1], tf[1])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy().astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(jf[3]), tf[2].numpy())
    assert tf[2].dtype == torch.int32
    return tf[2].numpy()


@pytest.mark.parametrize("name", DENSE)
def test_every_syndrome_classifies_identically(name):
    """All 2^1, 2^8 and 2^15 syndromes."""
    status = _classify_both(name, np.arange(1 << tcodes.get(name).n_check))
    n_corr = {"parity65": 0, "secded72": 72, "dected79": 3160}[name]
    assert (status == 1).sum() == n_corr and status[0] == 0


def test_ileave88_syndromes_classify_identically():
    """Every value of each 6-bit sub-syndrome (the others 0, and the others
    a fixed detected pattern), plus 2^16 random 24-bit syndromes."""
    subs = np.arange(64)
    for w in range(tileave.N_WAYS):
        spread = sum(((subs >> r) & 1) << (tileave.N_WAYS * r + w) for r in range(6))
        _classify_both("ileave88", spread)
        other = 0b000011  # even weight: detected, in the next subcode
        other_bits = sum(((other >> r) & 1) << (tileave.N_WAYS * r + (w + 1) % 4)
                         for r in range(6))
        _classify_both("ileave88", spread | other_bits)
    rnd = np.random.default_rng(0).integers(0, 1 << 24, 1 << 16)
    status = _classify_both("ileave88", rnd)
    assert set(np.unique(status)) <= {0, 1, 2}


def _flip_random_bits(rng, c, lo, hi, check, counts):
    """Flip ``counts[i]`` distinct random codeword bits of word i."""
    lo, hi, check = lo.copy(), hi.copy(), check.copy()
    for i, k in enumerate(counts):
        for b in rng.choice(64 + c.n_check, k, replace=False):
            if b < 32:
                lo[i] ^= np.uint32(1 << b)
            elif b < 64:
                hi[i] ^= np.uint32(1 << (b - 32))
            else:
                check[i] ^= c.check_dtype(1 << (b - 64))
    return lo, hi, check


def _check_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("name", ALL)
def test_codec_encode_decode_match_reference(name):
    """Plain encode and decode against the reference's numpy oracle and its
    kernels (interpret mode) on words with 0-3 flipped bits."""
    rng = np.random.default_rng(len(name))
    n = 3000
    j, t = jcodes.get(name), tcodes.get(name)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    check = j.encode_np(lo, hi)
    tcheck = t.encode(_words(lo), _words(hi))
    assert tcheck.dtype == t.check_torch_dtype
    np.testing.assert_array_equal(tcheck.numpy().view(j.check_dtype), check)
    np.testing.assert_array_equal(np.asarray(jops.encode(jnp.asarray(lo), jnp.asarray(hi),
                                                         codec=name)), check)
    flo, fhi, fch = _flip_random_bits(rng, j, lo, hi, check, rng.integers(0, 4, n))
    tlo, thi, tst = t.decode(_words(flo), _words(fhi), _check_tensor(fch))
    nlo, nhi, nst = j.decode_np(flo, fhi, fch)
    klo, khi, kst = jops.decode(*map(jnp.asarray, (flo, fhi, fch)), codec=name)
    for want in ((nlo, nhi, nst), tuple(map(np.asarray, (klo, khi, kst)))):
        np.testing.assert_array_equal(_u32(tlo), want[0])
        np.testing.assert_array_equal(_u32(thi), want[1])
        np.testing.assert_array_equal(tst.numpy(), want[2])


def _cuh_struct_bytes(trait: str) -> int:
    return int(re.search(rf"sizeof\({trait}::Global\) == (\d+)", CODEC_CUH).group(1))


@pytest.mark.parametrize("name", ALL)
def test_codec_kernel_table_layout(name):
    """Each codec's table bytes: masks first, then its classification tables,
    of the size the CUDA trait asserts; the codec id is the trait's."""
    c = tcodes.get(name)
    raw = c.kernel_tables(torch.device("cpu")).numpy()
    nc = c.n_check
    words = raw[: 8 * nc].view(np.uint32)
    np.testing.assert_array_equal(words[:nc], c.mask_lo)
    np.testing.assert_array_equal(words[nc:], c.mask_hi)
    trait = {"parity65": "Parity65", "secded72": "Secded72", "ileave88": "Ileave88",
             "dected79": "Dected79"}[name]
    ids = dict((k, int(v)) for k, v in re.findall(r"k(\w+?) = (\d)", CODEC_CUH.split(
        "enum CodecId")[1].split("};")[0]))
    assert ids[trait] == c.kernel_id == tcodes.names().index(name)
    rest = raw[8 * nc :]
    assert raw.size == _cuh_struct_bytes(trait)
    if name == "parity65":
        assert rest.size == 0
    elif name == "ileave88":
        np.testing.assert_array_equal(rest.view(np.int8), c.sub_lut)
    else:
        size = 1 << nc
        flips = rest[: 8 * size].view(np.uint32)
        np.testing.assert_array_equal(flips[:size], c.lut_flip_lo)
        np.testing.assert_array_equal(flips[size:], c.lut_flip_hi)
        np.testing.assert_array_equal(rest[8 * size :], c.lut_status.astype(np.uint8))
