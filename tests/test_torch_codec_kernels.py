"""Port parity: the plain versions of the codec-generic kernels (fused
inject+scrub in both forms, the token commit, the paged scrub-on-read) for
every registered codec against the reference kernels (Pallas interpret mode
on the CPU), bit for bit, counters and latched check bits included. The CUDA
kernels are held against these plain versions in tests/test_torch_gpu.py and
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import codes as jcodes
from repro.core import kvpages as jkv
from repro.kernels import ops as jops
from repro.kernels import paged_gather as jpg
from repro_torch import codes as tcodes
from repro_torch.kernels import ops as tops

ALL = ("parity65", "secded72", "ileave88", "dected79")


def _words(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _check(a: np.ndarray) -> torch.Tensor:
    """A check plane as the port carries it (uint8, or int32 bit patterns)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _np(t: torch.Tensor, dtype) -> np.ndarray:
    return t.numpy().view(dtype)


def _masks(rng, c, n, p=0.02):
    """Sparse random flips over the 64 + n_check codeword bits, plus bursts
    of 2-4 adjacent data bits on 2% of the words (ileave88's case)."""
    bits = rng.random((64 + c.n_check, n)) < p
    burst = rng.random(n) < 0.02
    start = rng.integers(0, 60, n)
    width = rng.integers(2, 5, n)
    for i in np.flatnonzero(burst):
        bits[start[i] : start[i] + width[i], i] = True
    w = (1 << np.arange(32, dtype=np.uint64))[:, None]
    mlo = (bits[:32] * w).sum(0).astype(np.uint32)
    mhi = (bits[32:64] * w).sum(0).astype(np.uint32)
    mch = (bits[64:] * w[: c.n_check]).sum(0).astype(c.check_dtype)
    return mlo, mhi, mch


def _planes(codec, n, seed):
    c = jcodes.get(codec)
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    return (lo, hi, c.encode_np(lo, hi), *_masks(rng, c, n))


def _port(lo, hi, chk, mlo, mhi, mch):
    return _words(lo), _words(hi), _check(chk), _words(mlo), _words(mhi), _check(mch)


def _assert_planes(t, j, c):
    np.testing.assert_array_equal(_np(t[0], np.uint32), np.asarray(j[0]))
    np.testing.assert_array_equal(_np(t[1], np.uint32), np.asarray(j[1]))
    assert t[2].dtype == tcodes.get(c.name).check_torch_dtype
    np.testing.assert_array_equal(_np(t[2], c.check_dtype), np.asarray(j[2]))


@pytest.mark.parametrize("reencode", [False, True])
@pytest.mark.parametrize("codec", ALL)
def test_inject_scrub_plain_matches_reference(codec, reencode):
    c = jcodes.get(codec)
    planes = _planes(codec, 4099, ALL.index(codec))
    j = jops.inject_scrub(*map(jnp.asarray, planes), codec=codec, reencode=reencode)
    t = tops.inject_scrub(*_port(*planes), codec=codec, reencode=reencode)
    _assert_planes(t, j, c)
    cnt = t[3].numpy()
    np.testing.assert_array_equal(cnt, np.asarray(j[3]))
    if tcodes.get(codec).exact_tallies:  # every word in exactly one outcome lane
        assert cnt[0] + cnt[1] + cnt[2] + cnt[3] == 4099
    assert cnt[5] > 0 and cnt[6] > 0  # multi-bit words are in the draw
    if not reencode:
        # the corrected lane counts genuine corrections: the decode restores
        # the clean data (the exact tallies of ileave88 and dected79)
        nlo, nhi, nst = c.decode_np(np.asarray(j[0]), np.asarray(j[1]), np.asarray(j[2]))
        restored = (nlo == planes[0]) & (nhi == planes[1])
        assert cnt[1] == int(((nst == 1) & restored).sum())
        assert cnt[2] == int((nst == 2).sum()) > 0
        assert (cnt[1] > 0) == (c.corrects_random > 0)


@pytest.mark.parametrize("codec", ALL)
def test_inject_scrub_domains_plain_matches_reference(codec):
    c = jcodes.get(codec)
    planes = _planes(codec, 3001, 10 + ALL.index(codec))
    dom = np.repeat(np.arange(3, dtype=np.int32), [1000, 1500, 501])
    for reencode in (False, True):
        j = jops.inject_scrub_domains(*map(jnp.asarray, planes), jnp.asarray(dom), 3,
                                      codec=codec, reencode=reencode)
        t = tops.inject_scrub_domains(*_port(*planes), torch.from_numpy(dom), 3,
                                      codec=codec, reencode=reencode)
        _assert_planes(t, j, c)
        np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
        assert t[3].shape == (3, 8)


N_PAGES, WPP = 10, 64  # arena pages (plus one scratch row), words per page


@pytest.mark.parametrize("codec", ALL)
def test_encode_commit_plain_matches_reference(codec):
    """The token commit (split, encode under the codec, scatter) equals the
    reference's ``_commit_tokens`` (distinct destinations)."""
    c = jcodes.get(codec)
    token_words = 16
    lo, hi, chk = _planes(codec, (N_PAGES + 1) * WPP, 20)[:3]
    rng = np.random.default_rng(1)
    payload = rng.standard_normal((6, 2 * token_words)).astype(np.float32)
    pages = np.array([0, 3, 3, 5, 7, 1], np.int32)
    slots = np.array([0, 1, 3, 2, 0, 3], np.int32)
    j = jkv._commit_tokens(*map(jnp.asarray, (lo, hi, chk, payload, pages, slots)),
                           token_words=token_words, words_per_page=WPP, codec=codec)
    tlo, thi, tchk = _words(lo.copy()), _words(hi.copy()), _check(chk.copy())
    base = torch.from_numpy(pages.astype(np.int64) * WPP + slots * token_words)
    tops.encode_commit(torch.from_numpy(payload), base, token_words, tlo, thi, tchk,
                       codec=codec)
    _assert_planes((tlo, thi, tchk), j, c)


TABLES = {
    "unique": [0, 1, 2, 3, 4, 5, 6, 7],
    "faulty_scratch_dups": [N_PAGES, 5, N_PAGES, 5, 2, 2, N_PAGES, 0, 7, 7, 7],
}


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("codec", ALL)
def test_gather_scrub_plain_matches_reference(codec, table):
    """Payload, counters and the written-back arena equal the reference's
    gather -> scrub -> scatter, duplicate and scratch ids included; detected
    words keep their stored check bits (the DED latch) and the others are
    re-encoded over the corrected data."""
    c = jcodes.get(codec)
    lo, hi, chk, mlo, mhi, mch = _planes(codec, (N_PAGES + 1) * WPP, 30 + ALL.index(codec))
    lo, hi, chk = lo ^ mlo, hi ^ mhi, chk ^ mch
    ids = np.asarray(TABLES[table], np.int32)
    idx = ids[:, None] * WPP + np.arange(WPP)
    jlo, jhi, jpar, jcnt = jpg.gather_scrub_pages(
        jnp.asarray(lo[idx]), jnp.asarray(hi[idx]), jnp.asarray(chk[idx]), codec=codec
    )
    want = [a.copy() for a in (lo, hi, chk)]
    for plane, out in zip(want, (jlo, jhi, jpar)):
        plane[idx] = np.asarray(out)
    tlo, thi, tchk = _words(lo.copy()), _words(hi.copy()), _check(chk.copy())
    payload, cnt = tops.gather_scrub_pages(tlo, thi, tchk, torch.from_numpy(ids), WPP,
                                           codec=codec)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert cnt[:, 2].sum() > 0  # detected words
    if c.corrects_random:
        assert cnt[:, 1].sum() > 0
    words = payload.numpy().view(np.uint32).reshape(len(ids), WPP, 2)
    np.testing.assert_array_equal(words[..., 0], np.asarray(jlo))
    np.testing.assert_array_equal(words[..., 1], np.asarray(jhi))
    _assert_planes((tlo, thi, tchk), want, c)
    # the latch: detected rows keep the stored bits
    nst = c.decode_np(lo[idx], hi[idx], chk[idx])[2]
    out = _np(tchk, c.check_dtype)[idx]
    np.testing.assert_array_equal(out[nst == 2], chk[idx][nst == 2])
