"""The CUDA kernels against their plain versions on the card.

Imports neither JAX nor the reference package, so it also runs on a
machine with the card and without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch import codes
from repro_torch.kernels import ecc_matmul as mm
from repro_torch.kernels import ops, ref

# float32 sums run in another order than the plain version's matmul
MATMUL_RTOL = 1e-4


@pytest.fixture
def cuda():
    """The card, decided inside the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _planes(n, p, device, seed=1):
    g = np.random.default_rng(seed)
    word = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(device)
    lo = word(g.integers(0, 2**32, n, dtype=np.uint32))
    hi = word(g.integers(0, 2**32, n, dtype=np.uint32))
    chk = codes.get("secded72").encode(lo, hi)
    bits = lambda k: (g.random((n, k)) < p).astype(np.uint64) @ (1 << np.arange(k, dtype=np.uint64))
    return lo, hi, chk, word(bits(32)), word(bits(32)), torch.from_numpy(
        bits(8).astype(np.uint8)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("reencode", [False, True])
def test_inject_scrub_kernel_bit_identical(cuda, reencode):
    planes = _planes(100_003, 0.01, cuda)
    k = ops.inject_scrub(*planes, reencode=reencode)
    p = ref.inject_scrub_ref(*planes, reencode=reencode)
    assert all(torch.equal(a, b) for a, b in zip(k, p))


@pytest.mark.gpu
def test_inject_scrub_domains_and_decode_kernels_bit_identical(cuda):
    planes = _planes(100_003, 0.01, cuda)
    sizes = torch.tensor([30_000, 50_000, 20_003], device=cuda)
    dom = torch.arange(3, device=cuda, dtype=torch.int32).repeat_interleave(sizes)
    k = ops.inject_scrub_domains(*planes, dom, 3)
    p = ref.inject_scrub_domains_ref(*planes, dom, 3)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    k2, p2 = ops.decode(*k[:3]), ref.decode_ref(*p[:3])
    assert all(torch.equal(a, b) for a, b in zip(k2, p2))


@pytest.mark.gpu
def test_inject_scrub_domains_kernel_drops_out_of_range_ids(cuda):
    """Ids outside [0, n_domains), between in-range runs: counted in no row,
    and no count of theirs leaks into the next in-range row."""
    planes = _planes(100_003, 0.01, cuda)
    ids = torch.tensor([0, -1, 1, 3, 2, 7, 1, -5], device=cuda, dtype=torch.int32)
    sizes = torch.tensor([9_000, 20_000, 11_000, 15_000, 5_000, 25_000, 10_000, 5_003],
                         device=cuda)
    dom = ids.repeat_interleave(sizes)
    k = ops.inject_scrub_domains(*planes, dom, 3)
    p = ref.inject_scrub_domains_ref(*planes, dom, 3)
    assert all(torch.equal(a, b) for a, b in zip(k, p))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 1024, 2048), (128, 3072, 1024), (5, 136, 70),
                                   (1, 1024, 2048), (16, 3072, 1024), (17, 1024, 3072)])
def test_ecc_matmul_kernel_within_tolerance(cuda, m, k, n):
    w = ops.pack_ecc_weights(torch.randn(k, n, device=cuda))
    x = torch.randn(m, k, device=cuda)
    out = ops.ecc_matmul(x, w)
    plain = ref.ecc_matmul_ref(x, w.lo, w.hi, w.parity, w.scale)
    torch.cuda.synchronize()
    assert float((out - plain).abs().max()) <= MATMUL_RTOL * float(plain.abs().max())


# qwen3-0.6b's seven (K, N) per layer, two with K8 % 8 != 0 and an N tail,
# and a K whose decode-kernel shared memory does not fit (the tiled kernel
# takes every M there)
ROW_SHAPES = {"wq": (1024, 2048), "wk": (1024, 1024), "wv": (1024, 1024),
              "wo": (2048, 1024), "w1": (1024, 3072), "w3": (1024, 3072),
              "w2": (3072, 1024), "k136_n70": (136, 70), "k784_n10": (784, 10),
              "k9216_n64": (9216, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", ROW_SHAPES.values(), ids=ROW_SHAPES.keys())
def test_ecc_matmul_rows_invariant_across_m(cuda, k, n):
    """A row's output is the same floats in a call of any M: the decode
    kernel's rows (M = 1, 4, 16, x aligned and not) equal the tiled
    kernel's (M = 17, 128), on planes with single and double flips."""
    g = np.random.default_rng(k + n)
    w = ops.pack_ecc_weights(torch.from_numpy(g.standard_normal((k, n), np.float32)).to(cuda))
    flips = np.zeros(w.lo.numel(), np.uint32)
    hit = g.choice(flips.size, flips.size // 20, replace=False)
    flips[hit] = 1 << g.integers(0, 32, hit.size, dtype=np.uint32)
    flips[hit[::7]] |= 1 << 3  # some words get a second flip: detected, not corrected
    w.lo = w.lo ^ torch.from_numpy(flips.view(np.int32)).to(cuda).view(w.lo.shape)
    x = torch.from_numpy(g.standard_normal((128, k), np.float32)).to(cuda)
    before = ops.launch_counts()["ecc_matmul"]
    tiled = [ops.ecc_matmul(x[:m], w) for m in (mm.DECODE_MAX_M + 1, 128)]
    for m in (1, 4, mm.DECODE_MAX_M):
        shifted = torch.empty(m * k + 1, device=cuda)[1:].view(m, k)  # 4 B off alignment
        shifted.copy_(x[:m])
        for rows in (ops.ecc_matmul(x[:m], w), ops.ecc_matmul(shifted, w)):
            assert rows.shape == (m, n)
            assert all(torch.equal(rows, t[:m]) for t in tiled)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ecc_matmul"] == before + 2 + 3 * 2


@pytest.mark.gpu
def test_encode_kernel_bit_identical(cuda):
    lo, hi = _planes(100_003, 0.0, cuda)[:2]
    assert torch.equal(ops.encode(lo, hi), ref.encode_ref(lo, hi))
    w = ops.pack_ecc_weights(torch.randn(1024, 192, device=cuda))
    assert torch.equal(w.parity, ref.encode_ref(w.lo, w.hi))


@pytest.mark.gpu
def test_encode_commit_kernel_bit_identical(cuda):
    wpp, tw = 4096, 512
    lo, hi, chk = _planes(9 * wpp, 0.0, cuda)[:3]
    payload = torch.randn(16, 2 * tw, device=cuda)
    base = torch.tensor([(i * 5 % 9) * wpp + (i % 8) * tw for i in range(16)], device=cuda)
    k, p = [lo.clone(), hi.clone(), chk.clone()], [lo.clone(), hi.clone(), chk.clone()]
    ops.encode_commit(payload, base, tw, *k)
    ref.encode_commit_ref(payload, base, tw, *p)
    assert all(torch.equal(a, b) for a, b in zip(k, p))


@pytest.mark.gpu
def test_gather_scrub_kernel_bit_identical_with_duplicate_ids(cuda):
    """Duplicate ids, among them a row with faults, read the words as they
    were before the launch: a corrected word counts as corrected in every
    copy."""
    wpp = 8192
    lo, hi, chk, mlo, mhi, mchk = _planes(17 * wpp, 0.002, cuda)
    planes = [lo ^ mlo, hi ^ mhi, chk ^ mchk]
    ids = torch.tensor([3, 16, 3, 16, 16, 0, 7, 3, 9, 9], dtype=torch.int32, device=cuda)
    k_planes = [t.clone() for t in planes]
    k = ops.gather_scrub_pages(*k_planes, ids, wpp)
    p = ref.gather_scrub_ref(*planes, ids, wpp)
    torch.cuda.synchronize()
    assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
    assert torch.equal(k[1], p[1])
    assert int(k[1][:, 1].min()) > 0  # every row, duplicates too, saw corrections
    assert all(torch.equal(a, b) for a, b in zip(k_planes, planes))


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [(100_003, 0), (4_099, 1), (7, 0), (1, 3), (3 * 17 * 70, 0)])
def test_inject_kernel_bit_identical(cuda, n, offset):
    """Lengths that are not a multiple of 4 or 16 (the check plane's tail),
    planes that start off the 16-byte boundary (the one-word path), and a
    stacked 3D leaf."""
    planes = [t[offset:] for t in _planes(n + offset, 0.02, cuda)]
    if n == 3 * 17 * 70:
        planes = [t.reshape(3, 17, 70) for t in planes]
    before = ops.launch_counts()["inject"]
    k = ops.inject(*planes)
    p = ref.inject_ref(*planes)
    torch.cuda.synchronize()
    assert ops.launch_counts()["inject"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert k[2].dtype == torch.uint8 and k[2].shape == planes[2].shape


CODECS = ("parity65", "secded72", "ileave88", "dected79")


def _codec_planes(codec, n, p, device, seed=2):
    """Random clean planes under ``codec`` and flip masks over its codeword
    bits (per-bit probability p, plus 4-bit data bursts on 1% of words)."""
    c = codes.get(codec)
    g = np.random.default_rng(seed)
    word = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(device)
    lo = word(g.integers(0, 2**32, n, dtype=np.uint32))
    hi = word(g.integers(0, 2**32, n, dtype=np.uint32))
    bits = g.random((n, 64 + c.n_check)) < p
    burst = np.flatnonzero(g.random(n) < 0.01)
    start = g.integers(0, 60, burst.size)
    for i, s in zip(burst, start):
        bits[i, s : s + 4] = True
    pack = lambda b: b.astype(np.uint64) @ (1 << np.arange(b.shape[1], dtype=np.uint64))
    mchk = pack(bits[:, 64:]).astype(c.check_dtype)
    mchk = torch.from_numpy(mchk.view(np.int32) if c.n_check > 8 else mchk).to(device)
    return (lo, hi, c.encode(lo, hi), word(pack(bits[:, :32])), word(pack(bits[:, 32:64])),
            mchk)


@pytest.mark.gpu
@pytest.mark.parametrize("codec", CODECS)
def test_codec_inject_scrub_kernels_bit_identical(cuda, codec):
    """Both forms, both re-encode settings; the counters include the exact
    tallies of the multi-bit correctors."""
    planes = _codec_planes(codec, 200_003, 0.01, cuda)
    dom = torch.arange(3, device=cuda, dtype=torch.int32).repeat_interleave(
        torch.tensor([60_000, 100_000, 40_003], device=cuda))
    for reencode in (False, True):
        k = ops.inject_scrub(*planes, codec=codec, reencode=reencode)
        p = ref.inject_scrub_ref(*planes, codec=codec, reencode=reencode)
        assert all(torch.equal(a, b) for a, b in zip(k, p))
        assert k[2].dtype == codes.get(codec).check_torch_dtype
        k = ops.inject_scrub_domains(*planes, dom, 3, codec=codec, reencode=reencode)
        p = ref.inject_scrub_domains_ref(*planes, dom, 3, codec=codec, reencode=reencode)
        assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert int(p[3][:, 2].sum()) == 0  # re-encoded: nothing detected
    k = ops.inject_scrub(*planes, codec=codec)
    assert int(k[3][2]) > 0 and (int(k[3][1]) > 0) == (codec != "parity65")


@pytest.mark.gpu
@pytest.mark.parametrize("codec", CODECS)
def test_codec_encode_decode_kernels_bit_identical(cuda, codec):
    lo, hi, chk, mlo, mhi, mchk = _codec_planes(codec, 200_003, 0.01, cuda)
    assert torch.equal(ops.encode(lo, hi, codec=codec), chk)
    faulty = (lo ^ mlo, hi ^ mhi, chk ^ mchk)
    k = ops.decode(*faulty, codec=codec)
    p = ref.decode_ref(*faulty, codec=codec)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert set(torch.unique(k[2]).tolist()) == ({0, 2} if codec == "parity65" else {0, 1, 2})


@pytest.mark.gpu
@pytest.mark.parametrize("codec", CODECS)
def test_codec_commit_and_gather_scrub_kernels_bit_identical(cuda, codec):
    wpp, tw = 8192, 512
    lo, hi, chk, mlo, mhi, mchk = _codec_planes(codec, 17 * wpp, 0.003, cuda)
    payload = torch.randn(16, 2 * tw, device=cuda)
    base = torch.tensor([(i * 5 % 17) * wpp + (i % 16) * tw for i in range(16)], device=cuda)
    k, p = [t.clone() for t in (lo, hi, chk)], [t.clone() for t in (lo, hi, chk)]
    ops.encode_commit(payload, base, tw, *k, codec=codec)
    ref.encode_commit_ref(payload, base, tw, *p, codec=codec)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    planes = [k[0] ^ mlo, k[1] ^ mhi, k[2] ^ mchk]
    ids = torch.tensor([3, 16, 3, 16, 16, 0, 7, 3, 9, 9], dtype=torch.int32, device=cuda)
    k_planes = [t.clone() for t in planes]
    kg = ops.gather_scrub_pages(*k_planes, ids, wpp, codec=codec)
    pg = ref.gather_scrub_ref(*planes, ids, wpp, codec=codec)
    torch.cuda.synchronize()
    assert torch.equal(kg[0].view(torch.int32), pg[0].view(torch.int32))
    assert torch.equal(kg[1], pg[1])
    assert all(torch.equal(a, b) for a, b in zip(k_planes, planes))
    assert int(kg[1][:, 2].sum()) > 0


@pytest.mark.gpu
def test_codec_launches_counted_per_codec(cuda):
    ops.reset_launch_count()
    for codec in CODECS:
        planes = _codec_planes(codec, 1000, 0.01, cuda)
        ops.inject_scrub(*planes, codec=codec)
        ops.encode(*planes[:2], codec=codec)
        ops.encode(*planes[:2], codec=codec)
    by = ops.launch_counts_by_codec()
    assert by["inject_scrub"] == dict.fromkeys(CODECS, 1)
    assert by["encode"] == dict.fromkeys(CODECS, 2)
    assert ops.launch_counts()["encode"] == 8
