"""Port parity for the paged path's kernels: the plain versions of the SECDED
encode (B4) and the paged scrub-on-read (B6) against the reference kernels
(Pallas interpret mode on the CPU), bit for bit, and the two entry points the
encode now serves: weight packing and the store's device."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ecc as jecc
from repro.core import kvpages as jkv
from repro.kernels import ops as jops
from repro.kernels import paged_gather as jpg
from repro_torch.core import planestore as tps
from repro_torch.core import voltage as tv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_gather as tpg
from repro_torch.kernels import ref as tref


def _words(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("shape", [(1,), (1000,), (37, 29), (3, 8, 64)])
def test_encode_plain_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    lo = rng.integers(0, 2**32, shape, dtype=np.uint32)
    hi = rng.integers(0, 2**32, shape, dtype=np.uint32)
    j = np.asarray(jops.encode(jnp.asarray(lo), jnp.asarray(hi)))
    np.testing.assert_array_equal(tref.encode_ref(_words(lo), _words(hi)).numpy(), j)
    np.testing.assert_array_equal(tops.encode(_words(lo), _words(hi)).numpy(), j)


N_PAGES, WPP = 12, 96  # arena pages (plus one scratch row), words per page


def _arena(seed):
    """Clean random arena planes with 0-, 1- and 2-bit faults in data and
    check bits on chosen pages."""
    rng = np.random.default_rng(seed)
    n = (N_PAGES + 1) * WPP
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    chk = jecc.encode_np(lo, hi)
    for page, flips in ((1, 1), (2, 2), (4, 1), (5, 2), (N_PAGES, 1), (7, 3)):
        for w in rng.choice(WPP, 9, replace=False):
            i = page * WPP + w
            for b in rng.choice(72, flips, replace=False):
                if b < 32:
                    lo[i] ^= np.uint32(1 << b)
                elif b < 64:
                    hi[i] ^= np.uint32(1 << (b - 32))
                else:
                    chk[i] ^= np.uint8(1 << (b - 64))
    return lo, hi, chk


TABLES = {
    "unique": [0, 1, 2, 3, 4, 5, 6, 7],
    "duplicates": [1, 2, 1, 5, 2, 2, 9, 1],
    "scratch_tail": [4, 7, N_PAGES, N_PAGES, 1, N_PAGES, N_PAGES, N_PAGES],
    "faulty_scratch_dups": [N_PAGES, 5, N_PAGES, 5, 2, 2, N_PAGES, 0, 7, 7, 7],
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_gather_scrub_plain_matches_reference(name):
    """Payload, counters and the written-back arena equal the reference's
    gather -> scrub -> scatter, duplicate ids included (every row from the
    words as they were before the call)."""
    lo, hi, chk = _arena(3)
    ids = np.asarray(TABLES[name], np.int32)
    idx = ids[:, None] * WPP + np.arange(WPP)
    jlo, jhi, jpar, jcnt = jpg.gather_scrub_pages(
        jnp.asarray(lo[idx]), jnp.asarray(hi[idx]), jnp.asarray(chk[idx])
    )
    want_payload = np.asarray(jkv._planes_to_payload(jlo.reshape(-1, 16), jhi.reshape(-1, 16)))
    want = [a.copy() for a in (lo, hi, chk)]
    for plane, out in zip(want, (jlo, jhi, jpar)):
        plane[idx] = np.asarray(out)
    tlo, thi, tchk = _words(lo), _words(hi), torch.from_numpy(chk.copy())
    payload, cnt = tops.gather_scrub_pages(tlo, thi, tchk, torch.from_numpy(ids), WPP)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert cnt[:, 1].sum() > 0 and cnt[:, 2].sum() > 0  # corrected and detected words
    np.testing.assert_array_equal(
        payload.numpy().view(np.uint32).reshape(-1, 32), want_payload.view(np.uint32)
    )
    np.testing.assert_array_equal(_u32(tlo), want[0])
    np.testing.assert_array_equal(_u32(thi), want[1])
    np.testing.assert_array_equal(tchk.numpy(), want[2])


def test_encode_commit_plain_matches_reference_commit():
    """The fused encode + scatter of a token commit equals the reference's
    ``_commit_tokens`` (distinct destinations)."""
    token_words, wpp = 16, 64
    lo, hi, chk = _arena(5)
    lo, hi, chk = lo[: 8 * wpp], hi[: 8 * wpp], chk[: 8 * wpp]
    rng = np.random.default_rng(1)
    payload = rng.standard_normal((6, 2 * token_words)).astype(np.float32)
    pages = np.array([0, 3, 3, 5, 7, 1], np.int32)
    slots = np.array([0, 1, 3, 2, 0, 3], np.int32)
    j = jkv._commit_tokens(
        *map(jnp.asarray, (lo, hi, chk, payload, pages, slots)),
        token_words=token_words, words_per_page=wpp,
    )
    tlo, thi, tchk = _words(lo), _words(hi), torch.from_numpy(chk.copy())
    base = torch.from_numpy(pages.astype(np.int64) * wpp + slots * token_words)
    tops.encode_commit(torch.from_numpy(payload), base, token_words, tlo, thi, tchk)
    np.testing.assert_array_equal(_u32(tlo), np.asarray(j[0]))
    np.testing.assert_array_equal(_u32(thi), np.asarray(j[1]))
    np.testing.assert_array_equal(tchk.numpy(), np.asarray(j[2]))


@pytest.mark.parametrize("k,n", [(64, 96), (256, 64)])
def test_pack_encodes_through_ops_encode(monkeypatch, k, n):
    """Packing takes its check plane from ``ops.encode`` (the kernel on the
    card) and the planes equal the reference's."""
    w = np.random.default_rng(k).standard_normal((k, n)).astype(np.float32)
    calls = []
    real = tops.encode
    monkeypatch.setattr(tops, "encode", lambda lo, hi, **kw: calls.append(lo.shape) or real(lo, hi, **kw))
    t = tops.pack_ecc_weights(torch.from_numpy(w))
    j = jops.pack_ecc_weights(jnp.asarray(w))
    assert calls == [(k // 8, n)]
    np.testing.assert_array_equal(_u32(t.lo), np.asarray(j.lo))
    np.testing.assert_array_equal(_u32(t.hi), np.asarray(j.hi))
    np.testing.assert_array_equal(t.parity.numpy(), np.asarray(j.parity))


def test_planestore_device_follows_leaves_else_the_card():
    """``device=None`` follows the leaves; with none it resolves to the card
    like every entry point (and raises where there is none)."""
    w = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32)
    leaf = tops.pack_ecc_weights(torch.from_numpy(w))
    store = tps.PlaneStore([leaf], ["['blocks']['p0']['attn']['wq']"], tv.PLATFORMS["vc707"])
    assert store.device == torch.device("cpu")
    j = jops.pack_ecc_weights(jnp.asarray(w))
    np.testing.assert_array_equal(_u32(store.lo), np.asarray(j.lo).reshape(-1))
    np.testing.assert_array_equal(store.parity.numpy(), np.asarray(j.parity).reshape(-1))
    empty = tps.PlaneStore([], [], tv.PLATFORMS["vc707"], device="cpu")
    assert empty.device == torch.device("cpu") and empty.n_words == 0
    if torch.cuda.is_available():
        assert tps.PlaneStore([], [], tv.PLATFORMS["vc707"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tps.PlaneStore([], [], tv.PLATFORMS["vc707"])


@pytest.mark.parametrize("wpp", [1, 2, 3, 4, 5, 127, 128, 129, 1001, 8192, 229376])
def test_gather_scrub_record_holds_every_word(wpp):
    """The wrapper sizes the changed-word record as the card's launcher
    checks it: its chunk and record constants and its chunks_per_row are
    the CUDA source's (the C++ expressions evaluated here), and the chunks
    of a row cover its W words at any offset of the page base from a
    four-word boundary (up to three words)."""
    src = (Path(tpg.__file__).parent / "csrc" / "paged_gather.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    chunk_quads, record = const("kChunkQuads"), const("kRecordWords")
    assert (4 * chunk_quads, record) == (tpg.CHUNK_WORDS, tpg.RECORD_WORDS_PER_CHUNK)
    body = re.search(r"long long chunks_per_row\(long long words_per_page\) \{(.*?)\n\}",
                     src, re.S).group(1)
    quads_expr = re.search(r"const long long quads = (.*?);", body).group(1)
    chunks_expr = re.search(r"return (.*?);", body).group(1)
    c_div = lambda expr, **env: eval(expr.replace("/", "//"), {}, env)  # integer C division
    quads = c_div(quads_expr, words_per_page=wpp)
    chunks = c_div(chunks_expr, quads=quads, kChunkQuads=chunk_quads)
    assert tpg.chunks_per_row(wpp) == chunks
    assert chunks * tpg.CHUNK_WORDS >= wpp + 3
    # the launcher refuses record_words < n_rows * chunks * kRecordWords
    for n_rows in (1, 40):
        assert tpg.record_words(n_rows, wpp) == n_rows * chunks * record


@pytest.mark.parametrize("codec", ["parity65", "secded72", "ileave88", "dected79"])
def test_syndrome_zero_is_clean_without_flips(codec):
    """The card's paged scrub neither classifies nor writes back a word whose
    syndrome is 0: every codec reads it as clean with no flips, so its
    corrected words and re-encoded check bits are the stored ones."""
    from repro_torch import codes

    flo, fhi, status = codes.get(codec).classify(torch.zeros(1, dtype=torch.int64))
    assert (int(flo[0]), int(fhi[0]), int(status[0])) == (0, 0, codes.STATUS_CLEAN)
