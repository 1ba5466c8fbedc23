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
from repro_torch.kernels import fault_field as fault_field_kernel
from repro_torch.kernels import ops, ref

# the tensor cores sum in another order than the plain version's matmul
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
                                   (1, 1024, 2048), (16, 3072, 1024), (17, 1024, 3072),
                                   (20, 1024, 3072),
                                   # the Fig. 3 MLP's predict over its 4,000 test images
                                   (4000, 784, 256), (4000, 256, 128), (4000, 128, 10)])
def test_ecc_matmul_kernel_within_tolerance(cuda, m, k, n):
    w = ops.pack_ecc_weights(torch.randn(k, n, device=cuda))
    x = torch.randn(m, k, device=cuda)
    out = ops.ecc_matmul(x, w)
    plain = ref.ecc_matmul_ref(x, w.lo, w.hi, w.parity, w.scale)
    torch.cuda.synchronize()
    assert float((out - plain).abs().max()) <= MATMUL_RTOL * float(plain.abs().max())



@pytest.mark.gpu
@pytest.mark.parametrize("m,k,want", [(4, 3584, "decode"), (16, 8832, "decode"),
                                      (4, 8840, "tiled"), (4, 18944, "tiled"),
                                      (17, 3584, "tiled")])
def test_ecc_matmul_launches_the_kernel_it_names(cuda, m, k, want):
    """``kernel_for`` names the kernel the launcher runs (the profiler's
    event), and the wrapper counts the launch under it: qwen2-7b's w2
    (K = 18,944) takes the tiled kernel even at M = 4."""
    assert mm.kernel_for(m, k) == want
    w = ops.pack_ecc_weights(torch.randn(k, 64, device=cuda))
    x = torch.randn(m, k, device=cuda)
    ops.ecc_matmul(x, w)  # first launch outside the trace
    torch.cuda.synchronize()
    expect = {"decode": int(want == "decode"), "tiled": int(want == "tiled")}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(5):  # the profiler can drop a record: a window that saw none is redone
        ops.reset_launch_count()
        with torch.profiler.profile(activities=acts) as prof:
            ops.ecc_matmul(x, w)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        ran = {kind: sum(g in e for e in names) for kind, g in mm.GLOBAL_KERNELS.items()}
        assert ops.ecc_matmul_launches_by_kernel() == expect
        assert all(ran[kind] <= expect[kind] for kind in ran), names
        if ran == expect:
            break
    assert ran == expect, names

# minitron-8b's four (K, N): wq / wo, wk / wv, w1 and w2 (K = 16,384 takes
# the tiled kernel at every M)
MINITRON_SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "w1": (4096, 16384),
                   "w2": (16384, 4096)}


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 20, 128])
@pytest.mark.parametrize("k,n", MINITRON_SHAPES.values(), ids=MINITRON_SHAPES.keys())
def test_ecc_matmul_at_minitron_shapes(cuda, k, n, m):
    """B3 against its plain version at minitron-8b's shapes, each call
    counted under the kernel ``kernel_for`` names."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    w = ops.pack_ecc_weights(torch.randn(k, n, generator=g, device=cuda))
    x = torch.randn(m, k, generator=g, device=cuda)
    ops.reset_launch_count()
    out = ops.ecc_matmul(x, w)
    want = mm.kernel_for(m, k)
    assert ops.ecc_matmul_launches_by_kernel() == {"decode": int(want == "decode"),
                                                   "tiled": int(want == "tiled")}
    assert want == ("tiled" if m > 16 or k == 16384 else "decode")
    plain = ref.ecc_matmul_ref(x, w.lo, w.hi, w.parity, w.scale)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out - plain).abs().max()) <= MATMUL_RTOL * float(plain.abs().max())


@pytest.mark.gpu
def test_layer_norm_rows_do_not_depend_on_the_batch_on_the_card(cuda):
    from repro_torch.models import layers

    g = torch.Generator(device=cuda).manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        x = (3.0 * torch.randn(16, 5, 4096, generator=g, device=cuda) + 1.0).to(dt)
        gamma = (1.0 + 0.2 * torch.randn(4096, generator=g, device=cuda)).to(dt)
        beta = (0.2 * torch.randn(4096, generator=g, device=cuda)).to(dt)
        full = layers.layer_norm(x, gamma, beta)
        for i in range(16):
            assert torch.equal(layers.layer_norm(x[i:i + 1], gamma, beta), full[i:i + 1])
        assert torch.equal(layers.layer_norm(x[3, 2], gamma, beta), full[3, 2])


@pytest.mark.gpu
def test_ring_decode_equals_the_full_cache_windowed_decode_on_the_card(cuda):
    """A sliding-window ring against a position-indexed cache with the window
    as a mask, on the same tokens, on a small bf16 config: prefill and every
    decode step's logits and the ring's slots (slot j = position p with p %
    window = j) bit for bit, the key sums' upper tree levels folding
    positions onto slots by adding exact zeros."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), sliding_window=16,
                              param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    params = lm.init_params(cfg, seed=0, device=cuda)
    s0, n_new, max_len = 40, 12, 64
    toks = torch.randint(0, cfg.vocab, (3, s0 + n_new), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    ring = lm.init_cache(cfg, 3, max_len, device=cuda)
    full = lm.init_cache(dataclasses.replace(cfg, sliding_window=0), 3, max_len, device=cuda)
    assert ring["p0"]["k"].shape[2] == 16 and full["p0"]["k"].shape[2] == max_len
    rl, _ = lm.prefill(params, toks[:, :s0], cfg, ring)
    fl, _ = lm.prefill(params, toks[:, :s0], cfg, full)
    assert torch.equal(rl, fl)
    for pos in range(s0 - 16, s0):
        for name in ("k", "v"):
            assert torch.equal(ring["p0"][name][:, :, pos % 16], full["p0"][name][:, :, pos])
    for i in range(n_new):
        pos = s0 + i
        rl, _ = lm.decode_step(params, toks[:, pos:pos + 1], cfg, ring, pos)
        fl, _ = lm.decode_step(params, toks[:, pos:pos + 1], cfg, full, pos)
        assert bool(torch.isfinite(rl).all()) and torch.equal(rl, fl), i
    for name in ("k", "v"):
        for pos in range(s0 + n_new - 16, s0 + n_new):
            assert torch.equal(ring["p0"][name][:, :, pos % 16], full["p0"][name][:, :, pos])


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
    """A row's output is the same floats in a call of any M, on planes with
    single and double flips, against the rows of one call at M = 600
    (128-row tiles): at every position 0..15 of an MMA fragment (0..15
    other rows put before it, in the tiled kernel and in the decode
    kernel), on both sides of the 32-row tile boundaries (M = 17, 20, 63,
    64, 65, 128, 129), and in the decode kernel at M = 1, 4, 16 with x
    aligned and not. For a float32 x whose values are not bf16 (all three
    pieces of the split matter) and for a bf16-valued x (the LM's)."""
    g = np.random.default_rng(k + n)
    w = ops.pack_ecc_weights(torch.from_numpy(g.standard_normal((k, n), np.float32)).to(cuda))
    flips = np.zeros(w.lo.numel(), np.uint32)
    hit = g.choice(flips.size, flips.size // 20, replace=False)
    flips[hit] = 1 << g.integers(0, 32, hit.size, dtype=np.uint32)
    flips[hit[::7]] |= 1 << 3  # some words get a second flip: detected, not corrected
    w.lo = w.lo ^ torch.from_numpy(flips.view(np.int32)).to(cuda).view(w.lo.shape)
    xf = torch.from_numpy(g.standard_normal((600, k), np.float32)).to(cuda)
    assert not torch.equal(xf, xf.bfloat16().float())
    other = torch.from_numpy(g.standard_normal((15, k), np.float32)).to(cuda)
    before = ops.launch_counts()["ecc_matmul"]
    calls = 0
    for kind, x in (("f32", xf), ("bf16", xf.bfloat16().float())):
        want = ops.ecc_matmul(x, w)
        calls += 1
        for m in (mm.DECODE_MAX_M + 1, 20, 63, 64, 65, 128, 129):
            assert torch.equal(ops.ecc_matmul(x[:m], w), want[:m]), f"{kind} M={m}"
            calls += 1
        for p in range(16):
            for rows in (20, 1):  # M = p + 20: tiled kernel; M = p + 1: decode kernel
                out = ops.ecc_matmul(torch.cat([other[:p], x[:rows]]), w)
                assert torch.equal(out[p:], want[:rows]), f"{kind} {rows} rows at position {p}"
                calls += 1
        for m in (1, 4, mm.DECODE_MAX_M):
            shifted = torch.empty(m * k + 1, device=cuda)[1:].view(m, k)  # 4 B off alignment
            shifted.copy_(x[:m])
            for rows in (ops.ecc_matmul(x[:m], w), ops.ecc_matmul(shifted, w)):
                assert rows.shape == (m, n)
                assert torch.equal(rows, want[:m]), f"{kind} decode M={m}"
            calls += 2
    torch.cuda.synchronize()
    assert ops.launch_counts()["ecc_matmul"] == before + calls


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


# name -> (shape, offset of each of the six input planes); every case has
# words on the word path (a tail past the last 4,096-word block, or a plane
# off 16 bytes, which sends every word there)
INJECT_EDGES = {
    "n_1": ((1,), (0,) * 6),
    "n_3": ((3,), (0,) * 6),
    "n_5": ((5,), (0,) * 6),
    "n_4099": ((4099,), (0,) * 6),
    "n_not_multiple_of_16": ((3 * 4096 + 1005,), (0,) * 6),
    "planes_at_word_1": ((3 * 4096 + 1005,), (1,) * 6),
    "planes_at_word_2": ((4099,), (2,) * 6),
    "planes_at_word_3": ((4099,), (3,) * 6),
    "check_plane_at_byte_4": ((2 * 4096 + 16,), (0, 0, 4, 0, 0, 4)),
    "stacked_3d_leaf": ((3, 33, 130), (0,) * 6),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(INJECT_EDGES))
def test_inject_kernel_edge_planes(cuda, case):
    """One launch, bit-identical to the plain version (and so to
    torch.bitwise_xor), on 1, 3, 5 and 4,099 words, a length with whole
    4,096-word blocks and a tail that is not a multiple of 16, planes cut at
    word offsets 1-3, check planes 4 bytes off 16, and a stacked 3-D
    leaf."""
    shape, offsets = INJECT_EDGES[case]
    n = int(np.prod(shape))
    planes = [_at_offset(t, o).reshape(shape)
              for t, o in zip(_planes(n, 0.02, cuda, seed=7), offsets)]
    before = ops.launch_counts()["inject"]
    k = ops.inject(*planes)
    torch.cuda.synchronize()
    assert ops.launch_counts()["inject"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(k, ref.inject_ref(*planes)))
    assert all(a.shape == shape for a in k)


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


def _flipped_planes(codec, n, device, seed=8):
    """Clean planes of n words under ``codec`` with 0, 1, 2 or 3 codeword
    bits flipped in each word (random counts and bits), so every status
    appears: parity65 detects odd counts, secded72 corrects one flip and
    detects two, dected79 corrects two and detects three, ileave88 corrects
    one per subcode."""
    c = codes.get(codec)
    g = np.random.default_rng(seed)
    lo, hi, chk = _codec_planes(codec, n, 0.0, device, seed)[:3]
    width = 64 + c.n_check
    bits = np.zeros((n, width), bool)
    for i, k in enumerate(g.integers(0, 4, n)):
        bits[i, g.choice(width, k, replace=False)] = True
    pack = lambda b: b.astype(np.uint64) @ (1 << np.arange(b.shape[1], dtype=np.uint64))
    word = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(device)
    mchk = pack(bits[:, 64:]).astype(c.check_dtype)
    mchk = torch.from_numpy(mchk.view(np.int32) if c.n_check > 8 else mchk).to(device)
    return lo ^ word(pack(bits[:, :32])), hi ^ word(pack(bits[:, 32:64])), chk ^ mchk


# name -> (shape, offsets of lo, hi and the check plane); every case has
# words on the word path: the last n % 4 words, or every word where a plane
# is not aligned for quads
DECODE_EDGES = {
    "n_1": ((1,), (0, 0, 0)),
    "n_3": ((3,), (0, 0, 0)),
    "n_5": ((5,), (0, 0, 0)),
    "n_4099": ((4099,), (0, 0, 0)),
    "planes_at_word_1": ((4099,), (1, 1, 1)),
    "planes_at_word_2": ((4099,), (2, 2, 2)),
    "planes_at_word_3": ((4099,), (3, 3, 3)),
    "check_plane_off_a_quad": ((4099,), (0, 0, 1)),
    "stacked_3d_leaf": ((3, 17, 70), (0, 0, 0)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(DECODE_EDGES))
@pytest.mark.parametrize("codec", CODECS)
def test_decode_kernel_edge_planes(cuda, codec, case):
    """The decode bit-identical to its plain version, one launch, on 1, 3, 5
    and 4,099 words (the quad loop's tail), planes cut at word offsets 1-3
    and a check plane off a quad (the word loop) and a stacked 3-D leaf, on
    words with 0-3 flipped bits: the larger planes hold every status."""
    shape, offsets = DECODE_EDGES[case]
    n = int(np.prod(shape))
    faulty = _flipped_planes(codec, n, cuda)
    planes = [_at_offset(t, o).reshape(shape) for t, o in zip(faulty, offsets)]
    before = ops.launch_counts()["decode"]
    k = ops.decode(*planes, codec=codec)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode"] == before + 1
    p = ref.decode_ref(*planes, codec=codec)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert all(a.shape == shape for a in k) and k[2].dtype == torch.int32
    if n > 1000:
        want = {0, 2} if codec == "parity65" else {0, 1, 2}
        assert set(torch.unique(k[2]).tolist()) == want


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


def _b6_planes(codec, n, faults, device, seed=4):
    """Clean planes of n words under ``codec`` and their faulty copy:
    ``faults`` is None (no fault), a per-bit rate (with 4-bit bursts, as
    ``_codec_planes``) or "heavy" (one flip in every word, a second in one
    word of five)."""
    c = codes.get(codec)
    rate = faults if isinstance(faults, float) else 0.0
    lo, hi, chk, mlo, mhi, mchk = _codec_planes(codec, n, rate, device, seed)
    if faults is None:
        return (lo, hi, chk), (lo.clone(), hi.clone(), chk.clone())
    if faults != "heavy":
        return (lo, hi, chk), (lo ^ mlo, hi ^ mhi, chk ^ mchk)
    g = np.random.default_rng(seed)
    width = 64 + c.n_check
    bits = np.zeros((n, width), bool)
    bits[np.arange(n), g.integers(0, width, n)] = True
    two = np.flatnonzero(g.random(n) < 0.2)
    bits[two, g.integers(0, width, two.size)] ^= True
    pack = lambda b: b.astype(np.uint64) @ (1 << np.arange(b.shape[1], dtype=np.uint64))
    word = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(device)
    mchk = pack(bits[:, 64:]).astype(c.check_dtype)
    mchk = torch.from_numpy(mchk.view(np.int32) if c.n_check > 8 else mchk).to(device)
    return (lo, hi, chk), (lo ^ word(pack(bits[:, :32])), hi ^ word(pack(bits[:, 32:64])),
                           chk ^ mchk)


def _at_offset(t, offset):
    """A copy of ``t`` that starts ``offset`` elements past an allocation's
    (aligned) start."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    buf[offset:] = t
    return buf[offset:]


# name -> (words per page, page ids of a 17-page arena, faults, plane offset)
B6_CASES = {
    "one_row": (8192, [11], 0.003, 0),
    "one_faulty_id_in_every_row": (8192, [6] * 9, 0.003, 0),
    "shared_ids_first_seen_late": (8192, [16, 2, 7, 2, 9, 16, 7, 0, 16], 0.003, 0),
    "pages_off_quad_boundary": (1001, [0, 1, 2, 3, 5, 3, 6, 1, 16, 15], 0.003, 0),
    "planes_off_16_bytes": (1001, [4, 9, 4, 1, 2], 0.003, 1),
    "most_words_change": (4096, [4, 4, 9, 1, 9, 12, 3], "heavy", 0),
    "all_clean": (8192, [3, 16, 3, 0, 7, 7, 12], None, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(B6_CASES))
@pytest.mark.parametrize("codec", CODECS)
def test_gather_scrub_kernel_edge_tables(cuda, codec, case):
    """Payload, counters and the three arena planes bit-identical to the
    plain version on tables of one row, of one faulty id in every row, of
    shared ids whose rows are not adjacent, with page bases that are not a
    multiple of four words, with planes that start off a 16-byte boundary,
    with most words changing, and on a clean arena, whose planes must keep
    their bytes."""
    wpp, ids, faults, offset = B6_CASES[case]
    clean, planes = _b6_planes(codec, 17 * wpp, faults, cuda)
    ids = torch.tensor(ids, dtype=torch.int32, device=cuda)
    k_planes = [_at_offset(t, offset) for t in planes]
    p_planes = [t.clone() for t in planes]
    before = ops.launch_counts()["gather_scrub"]
    k = ops.gather_scrub_pages(*k_planes, ids, wpp, codec=codec)
    p = ref.gather_scrub_ref(*p_planes, ids, wpp, codec=codec)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gather_scrub"] == before + 1
    assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
    assert torch.equal(k[1], p[1])
    assert all(torch.equal(a, b) for a, b in zip(k_planes, p_planes))
    assert torch.equal(k[1][:, :3].sum(dim=1), torch.full_like(k[1][:, 0], wpp))
    idx = ids.long()[:, None] * wpp + torch.arange(wpp, device=cuda)
    changed = sum((a[idx] != b[idx]) for a, b in zip(planes, p_planes)).bool()
    if faults is None:
        assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(k_planes, clean))
        assert int(k[1][:, 0].sum()) == idx.numel()
    elif faults == "heavy" and codec != "parity65":  # parity65 corrects nothing
        assert float(changed.float().mean()) > 0.5
    else:
        assert int(k[1][:, 2].sum()) > 0


@pytest.mark.gpu
def test_gather_scrub_kernel_refuses_a_short_record(cuda):
    """The kernel needs exactly the changed-word record the wrapper sizes
    (``record_words``; the other tests pass that size) and refuses a
    smaller one instead of writing past it."""
    from repro_torch.kernels import backend
    from repro_torch.kernels import paged_gather as pg

    lo, hi, chk = _planes(4 * 1001, 0.0, cuda)[:3]
    ids = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
    out = torch.empty(2, 1001, 2, dtype=torch.int32, device=cuda)
    cnt = torch.zeros(3, 8, dtype=torch.int32, device=cuda)
    short = pg.record_words(2, 1001) - 1
    rec = torch.empty(short, dtype=torch.int32, device=cuda)
    c = codes.get("secded72")
    with pytest.raises(RuntimeError, match="CUDA error"):
        pg.GATHER_SCRUB(c.kernel_id, *map(backend.ptr, (lo, hi, chk, ids)), 2, 1001,
                        backend.ptr(out), backend.ptr(rec), short, backend.ptr(cnt),
                        backend.ptr(c.kernel_tables(lo.device)),
                        backend.ptr(c.kernel_tables(torch.device("cpu"))), backend.stream(lo))


def _commit_table(tw, rows, shifts, seed=5):
    """Distinct destinations: row r at slot perm[r] of (tw + 4)-word slots,
    ``shifts[r]`` words in (0..3, so a row may start off a quad boundary);
    returns (row bases, arena words)."""
    perm = np.random.default_rng(seed).permutation(rows)
    base = perm * (tw + 4) + np.asarray(shifts)
    return torch.from_numpy(base.astype(np.int64)), rows * (tw + 4) + 8


# name -> (row words, rows, row shifts (None: 0), plane offset, payload
# offset); every case has words outside whole aligned quads (a row's tail,
# odd rows, unaligned bases or planes), so each reaches the word path
COMMIT_CASES = {
    "one_row": (510, 1, None, 0, 0),
    "one_word": (1, 1, None, 0, 0),
    "verify_block": (510, 20, None, 0, 0),
    "prompt_4x32": (510, 128, None, 0, 0),
    "odd_row_words_3": (3, 9, None, 0, 0),
    "odd_row_words_17": (17, 12, [1, 2, 3, 0] * 3, 0, 0),
    "odd_row_words_511": (511, 6, None, 0, 0),
    "bases_off_quad": (512, 8, [1, 2, 3, 0, 3, 2, 1, 1], 0, 0),
    "planes_off_16_bytes": (512, 6, None, 1, 0),
    "payload_off_16_bytes": (512, 6, None, 0, 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(COMMIT_CASES))
@pytest.mark.parametrize("codec", CODECS)
def test_encode_commit_kernel_edge_rows(cuda, codec, case):
    """The token commit bit-identical to its plain version, one launch, on
    one row, one word, a verify block, a prompt, odd row widths (payload
    words off 16 bytes), row bases off a quad boundary, planes and payload
    that start off a 16-byte boundary; no word outside the rows changes."""
    tw, rows, shifts, offset, p_off = COMMIT_CASES[case]
    base, n = _commit_table(tw, rows, [0] * rows if shifts is None else shifts)
    lo, hi, chk = _codec_planes(codec, n, 0.0, cuda)[:3]
    k = [_at_offset(t, offset) for t in (lo, hi, chk)]
    p = [t.clone() for t in (lo, hi, chk)]
    payload = _at_offset(torch.randn(rows, 2 * tw, device=cuda).reshape(-1), p_off)
    payload = payload.reshape(rows, 2 * tw)
    base = base.to(cuda)
    before = ops.launch_counts()["encode"]
    ops.encode_commit(payload, base, tw, *k, codec=codec)
    ref.encode_commit_ref(payload, base, tw, *p, codec=codec)
    torch.cuda.synchronize()
    assert ops.launch_counts()["encode"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    idx = base[:, None] + torch.arange(tw, device=cuda)
    untouched = torch.ones(n, dtype=torch.bool, device=cuda)
    untouched[idx.reshape(-1)] = False
    assert torch.equal(k[0][untouched], lo[untouched])


def _domain_ids(n, pattern, device):
    """Domain ids in runs: ``pattern`` is [(id, run length), ...], repeated
    to n words."""
    ids = np.concatenate([np.full(k, d, np.int32) for d, k in pattern])
    return torch.from_numpy(np.resize(ids, n)).to(device)


# name -> (words, input plane offsets (lo, hi, check, masks, ids), domain runs)
INJECT_CASES = {
    "planes_at_word_1": (4097, (1,) * 7, [(0, 1500), (1, 2597)]),
    "planes_at_word_2": (4097, (2,) * 7, [(0, 1500), (1, 2597)]),
    "planes_at_word_3": (4097, (3,) * 7, [(0, 1500), (1, 2597)]),
    "n_1": (1, (0,) * 7, [(2, 1)]),
    "n_3": (3, (0,) * 7, [(0, 1), (2, 2)]),
    "n_5": (5, (0,) * 7, [(1, 3), (0, 2)]),
    "n_4097": (4097, (0,) * 7, [(0, 1000), (1, 1000), (2, 2097)]),
    "one_plane_off_16_bytes": (4097, (0, 0, 0, 0, 0, 0, 3), [(0, 2000), (2, 2097)]),
    "boundaries_inside_quads": (
        4099, (0,) * 7, [(0, 5), (1, 3), (2, 7), (0, 1), (-1, 2), (1, 6), (3, 3), (2, 9)]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(INJECT_CASES))
@pytest.mark.parametrize("codec", CODECS)
def test_inject_scrub_kernels_edge_planes(cuda, codec, case):
    """Both inject+scrub forms, both re-encode settings, bit-identical to
    their plain versions on planes cut at word offsets 1-3 and on one plane
    off 16 bytes (the word loop), on 1, 3, 5 and 4,097 words (the quad
    loop's tail), and with domain boundaries inside quads and out-of-range
    ids (-1, 3 of 3 rows)."""
    n, offsets, runs = INJECT_CASES[case]
    planes = _codec_planes(codec, n, 0.02, cuda, seed=6)
    dom = _domain_ids(n, runs, cuda)
    *planes, dom = [_at_offset(t, o) for t, o in zip((*planes, dom), offsets)]
    before = dict(ops.launch_counts())
    for reencode in (False, True):
        k = ops.inject_scrub(*planes, codec=codec, reencode=reencode)
        p = ref.inject_scrub_ref(*planes, codec=codec, reencode=reencode)
        assert all(torch.equal(a, b) for a, b in zip(k, p))
        k = ops.inject_scrub_domains(*planes, dom, 3, codec=codec, reencode=reencode)
        p = ref.inject_scrub_domains_ref(*planes, dom, 3, codec=codec, reencode=reencode)
        assert all(torch.equal(a, b) for a, b in zip(k, p))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["inject_scrub"] == before["inject_scrub"] + 2
    assert after["inject_scrub_domains"] == before["inject_scrub_domains"] + 2
    if n > 1000:
        assert int(k[3][:, 7].sum()) > 0


FIELD_N_CHECKS = (1, 8, 15, 24)  # parity65, secded72, dected79, ileave88


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 3, 4097, 2**20 + 5])
@pytest.mark.parametrize("n_check", FIELD_N_CHECKS)
def test_fault_field_kernel_bit_identical(cuda, n_check, n):
    """The fault-field kernel against its plain version on the same row
    factor: a scalar rate and per-word rates (a third of the words at rate
    0, a third at another rail), a key with both 32-bit halves nonzero."""
    from repro_torch.core import faultsim
    from repro_torch.core.voltage import PLATFORMS

    plat = PLATFORMS["vc707"]
    f_row = faultsim.row_factor(n, plat.row_sigma, 77 + n, cuda)
    rates = torch.full((n,), plat.fault_rate(0.54), device=cuda)
    rates[n // 3: 2 * n // 3] = 0.0
    rates[2 * n // 3:] = plat.fault_rate(0.56)
    key = faultsim.philox_key(0x1234_5678_9ABC)
    before = ops.launch_counts()["fault_field"]
    for rate in (plat.fault_rate(0.54), rates):
        k = ops.fault_field(f_row, rate, key, n_check)
        p = ref.fault_field_ref(f_row, rate, key, n_check)
        torch.cuda.synchronize()
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(k, p))
    assert ops.launch_counts()["fault_field"] == before + 2 * (n > 0)
    if n > 2**20:
        assert all(int(m.count_nonzero()) > 0 for m in k)
        assert not any(m[n // 3: 2 * n // 3].any() for m in k)


def _burst_profiles():
    from repro_torch.core import scenario

    out = {c: scenario.BurstProfile(**{c: 1.0}) for c in (
        "double_adjacent", "triple_adjacent", "random_double", "word_adjacent")}
    out.update({e: p.burst for e, p in scenario.ENVIRONMENTS.items()})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n_check", FIELD_N_CHECKS)
def test_fault_field_burst_kernel_bit_identical(cuda, n_check):
    """The burst kernel against its plain version for each single-class
    profile and each environment's burst: a scalar rate and per-word rates
    with every third word at rate 0 (spills from and into words that draw
    nothing), a superset of the burst-free kernel's masks, one launch each,
    counted as a burst launch."""
    from repro_torch.core import faultsim
    from repro_torch.core.voltage import PLATFORMS

    plat = PLATFORMS["vc707"]
    n = 300_007
    f_row = faultsim.row_factor(n, plat.row_sigma, 91, cuda)
    rates = torch.full((n,), plat.fault_rate(0.54), device=cuda)
    rates[1::3] = 0.0
    rates[2::3] = plat.fault_rate(0.56)
    key = faultsim.philox_key(0xABCD_0123_4567)
    ops.reset_launch_count()
    drawn = 0
    for name, burst in _burst_profiles().items():
        for rate in (plat.fault_rate(0.54), rates):
            k = ops.fault_field(f_row, rate, key, n_check, burst=burst)
            p = ref.fault_field_plain(f_row, rate, key, n_check, ref.burst_thresholds(burst),
                                     chunk_words=ops.FIELD_CPU_CHUNK)
            free = ops.fault_field(f_row, rate, key, n_check)
            torch.cuda.synchronize()
            assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(k, p)), name
            assert all(torch.equal(a & b, a) for a, b in zip(free, k)), name
            assert not all(torch.equal(a, b) for a, b in zip(free, k)), name
            drawn += 1
    codec = {1: "parity65", 8: "secded72", 15: "dected79", 24: "ileave88"}[n_check]
    assert ops.burst_launch_counts() == {codec: drawn}
    assert ops.launch_counts()["fault_field"] == 2 * drawn


RUN = fault_field_kernel.RUN_WORDS
# around the burst kernel's runs: one warp, its edges, one run, three and a part
RUN_EDGE_SIZES = (1, 31, 32, 33, RUN - 1, RUN, RUN + 1, 3 * RUN + 5)


@pytest.mark.gpu
@pytest.mark.parametrize("n", RUN_EDGE_SIZES)
@pytest.mark.parametrize("n_check", FIELD_N_CHECKS)
def test_fault_field_burst_kernel_run_edges(cuda, n_check, n):
    """The burst kernel against its plain version at sizes around its run
    length, under word_adjacent = 1 and each environment's burst: a scalar
    rate, and per-word rates with each run's halo word and first stored
    word in turn at rate 0 and at another rail's rate."""
    from repro_torch.core import faultsim, scenario

    f_row = faultsim.row_factor(n, 0.9, 17 + n, cuda)
    key = faultsim.philox_key(0x5EED_0000 + n)
    bursts = {"word_adjacent": scenario.BurstProfile(word_adjacent=1.0)}
    bursts.update({e: p.burst for e, p in scenario.ENVIRONMENTS.items()})
    rates = [0.1]
    for where in (-1, 0):  # word k RUN - 1 (the halo), then k RUN (the first), k >= 1
        for value in (0.0, 0.02):
            rates.append(torch.full((n,), 0.1, device=cuda))
            rates[-1][RUN + where::RUN] = value
    for name, burst in bursts.items():
        for i, rate in enumerate(rates):
            k = ops.fault_field(f_row, rate, key, n_check, burst=burst)
            p = ref.fault_field_plain(f_row, rate, key, n_check, ref.burst_thresholds(burst),
                                     chunk_words=ops.FIELD_CPU_CHUNK)
            torch.cuda.synchronize()
            assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(k, p)), (name, i)


@pytest.mark.gpu
def test_device_mask_store_launches_the_field_per_drawn_group(cuda):
    """A device-mask plane store draws with the kernel once per codec group
    whose rail lies below V_min, and not at all at or above it."""
    from repro_torch.configs import shapes
    from repro_torch.core.planestore import PlaneStore
    from repro_torch.core.voltage import PLATFORMS

    g = np.random.default_rng(3)
    leaves = [ops.pack_ecc_weights(torch.from_numpy(g.standard_normal(s).astype(np.float32))
                                   .to(cuda)) for s in ((64, 96), (128, 64), (256, 64))]
    keys = ["['blocks']['p0']['attn']['wq']", "['blocks']['p0']['mlp']['w1']", "['embed']"]
    store = PlaneStore(leaves, keys, PLATFORMS["vc707"], seed=3, mask_source="device",
                       domain_key=shapes.domain_of,
                       codecs={"attention": "parity65", "mlp": "dected79"})
    assert len(store.groups) == 3
    ops.reset_launch_count()
    store.set_rails({d: 1.0 for d in store.domains})
    store.set_voltage(0.8)
    assert ops.launch_counts()["fault_field"] == 0
    _, stats = store.set_rails({"attention": 1.0, "mlp": 0.55, "embedding": 0.54})
    assert ops.launch_counts_by_codec()["fault_field"] == {"dected79": 1, "secded72": 1}
    assert stats["attention"].faulty_bits == 0 < stats["mlp"].faulty_bits
    _, s = store.set_voltage(0.55)
    assert ops.launch_counts()["fault_field"] == 5 and s.faulty_bits > 0
    assert ops.launch_counts()["inject_scrub"] == 6  # 0.8 V and 0.55 V, three groups each


@pytest.mark.gpu
def test_traced_serve_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """A tiny-config serve with a flight recorder gives the same JSONL trace
    on the card as on the CPU (the KV interval masks drawn from numpy for
    both, since the row factor's torch generator differs by device), and
    the profiler's rows on the card are CUDA-event rows tagged ``cuda``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import faultsim
    from repro_torch.models import lm
    from repro_torch.obs import KernelProfiler, TraceRecorder
    from repro_torch.obs import profile as obs_profile
    from repro_torch.serving.engine import RailsConfig, ReliabilityConfig, ServingEngine

    def masks(seed, interval, n, rate, sigma, n_check=8, device=None):
        g = np.random.default_rng((seed, interval))
        bits = g.random((64 + n_check, n), dtype=np.float32) < np.float32(rate * 6)
        w = (1 << np.arange(32, dtype=np.uint64))[:, None]
        mant = np.uint32((1 << 23) - 1)  # data flips on mantissa bits only
        lo = (bits[:32] * w).sum(0).astype(np.uint32) & mant
        hi = (bits[32:64] * w).sum(0).astype(np.uint32) & mant
        return lo, hi, (bits[64:] * w[:n_check]).sum(0).astype(np.uint8)

    monkeypatch.setattr(faultsim, "interval_masks", masks)
    cfg = get_smoke_config("qwen3-0.6b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    g = np.random.default_rng(0)
    reqs = [(g.integers(0, cfg.vocab, 6 + 3 * i).astype(np.int32), 5 + i) for i in range(4)]
    rel = ReliabilityConfig(mode="inline", voltage=1.0,
                            rails=RailsConfig(multi_rail=True, start_v=0.57))
    traces, prof = {}, KernelProfiler()
    for d in ("cpu", "cuda"):
        rec = TraceRecorder()
        eng = ServingEngine(cfg, params, rel=rel, max_len=48, device=d, recorder=rec)
        if d == "cuda":
            obs_profile.enable(prof)
        try:
            rep = eng.serve(reqs, n_lanes=2, n_pages=8, scrub_interval=2, walk_kv=True,
                            share_prefix=True)
        finally:
            obs_profile.disable()
        assert rep.kv_stats.corrected > 0
        traces[d] = rec.to_jsonl()
    assert traces["cuda"] == traces["cpu"]
    rows = {r["name"]: r for r in prof.to_rows()}
    assert {"decode.prefill", "decode.multistep", "kv.inject_masks"} <= set(rows)
    assert all(r["backend"] == "cuda" and r["calls"] > 0 for r in rows.values())


@pytest.mark.gpu
def test_escalating_serve_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """A tiny-config walk_kv serve whose kv rail steps up its code
    mid-stream (secded72 -> dected79) gives the same tokens, counters, rail
    history, final code and JSONL trace on the card as on the CPU, with the
    KV interval masks drawn from numpy for both (their check plane follows
    the code's width)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import faultsim
    from repro_torch.models import lm
    from repro_torch.obs import TraceRecorder
    from repro_torch.serving.engine import (
        ProtectionConfig, RailsConfig, ReliabilityConfig, ServingEngine,
    )

    def masks(seed, interval, n, rate, sigma, n_check=8, device=None):
        g = np.random.default_rng((seed, interval))
        bits = g.random((64 + n_check, n), dtype=np.float32) < np.float32(rate * 40)
        w = (1 << np.arange(32, dtype=np.uint64))[:, None]
        mant = np.uint32((1 << 23) - 1)  # data flips on mantissa bits only
        lo = (bits[:32] * w).sum(0).astype(np.uint32) & mant
        hi = (bits[32:64] * w).sum(0).astype(np.uint32) & mant
        chk = (bits[64:] * w[:n_check]).sum(0)
        return lo, hi, chk.astype(np.uint8 if n_check <= 8 else np.uint32)

    monkeypatch.setattr(faultsim, "interval_masks", masks)
    cfg = get_smoke_config("qwen3-0.6b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    g = np.random.default_rng(0)
    reqs = [(g.integers(0, cfg.vocab, 6 + 3 * i).astype(np.int32), 8 + i) for i in range(4)]
    rel = ReliabilityConfig(mode="inline", voltage=1.0,
                            rails=RailsConfig(multi_rail=True, start_v=0.57),
                            protection=ProtectionConfig(escalation=("secded72", "dected79")))
    out = {}
    for d in ("cpu", "cuda"):
        rec = TraceRecorder()
        eng = ServingEngine(cfg, params, rel=rel, max_len=48, device=d, recorder=rec)
        rep = eng.serve(reqs, n_lanes=2, n_pages=10, scrub_interval=1, walk_kv=True,
                        share_prefix=True)
        kv = eng.controller.rails["kv"]
        out[d] = ({r: v.tolist() for r, v in rep.outputs.items()}, rep.kv_stats.to_dict(),
                  rep.kv_voltages, [(r.voltage, r.detected, r.action, r.codec) for r in kv.history],
                  rep.arena.codec_name, eng.power_report(), rec.to_jsonl())
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][4] == "dected79" and '"kind":"kv_codec_change"' in out["cuda"][6]


def _moe_layer(cuda, arch, d=1024, f=512, seed=0):
    """Layer 0's MoE parameters of ``arch``'s smoke config widened to d / f,
    in bf16 on the card, and the config."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=1, d_model=d, d_ff=f,
                              n_heads=8, n_kv_heads=2, head_dim=128,
                              param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    p = lm.init_params(cfg, seed=seed, device=cuda)["blocks"]["p0"]["moe"]
    return cfg, {k: v[0] for k, v in p.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_rows_do_not_depend_on_groups_or_capacity_on_the_card(cuda, arch):
    """A token's MoE output is the same bits alone, in a batch of 4 (one
    decode group), in per-row groups and at any capacity that drops none
    of its assignments."""
    import dataclasses

    from repro_torch.models import moe

    cfg, p = _moe_layer(cuda, arch)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4, 6, cfg.d_model, generator=g, device=cuda).to(torch.bfloat16)
    for xs in (x[:, :1], x):
        outs = []
        for cf in (cfg.n_experts / cfg.top_k, 2.0 * cfg.n_experts):
            c = dataclasses.replace(cfg, capacity_factor=cf)
            full = moe.moe_ffn(xs, p, c)
            assert bool(torch.isfinite(full).all())
            for r in range(4):
                assert torch.equal(moe.moe_ffn(xs[r:r + 1], p, c)[0], full[r])
            outs.append(full)
        assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_routing_on_the_card_equals_the_cpu_routing(cuda, arch):
    """The card's top-k and sort dispatch over the card's router logits
    equal the CPU's over the same logits, at the published capacity factor
    (drops) and in both groupings; ties (a zero row) take the lower
    experts."""
    from repro_torch.models import moe

    cfg, p = _moe_layer(cuda, arch)
    g = torch.Generator(device=cuda).manual_seed(4)
    for shape in ((1, 4), (4, 32)):
        x = torch.randn(*shape, cfg.d_model, generator=g, device=cuda).to(torch.bfloat16)
        x[0, 1] = 0
        logits = moe.router_logits(x, p["router"])
        cap = moe.capacity(shape[1], cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        got = moe.topk_from_logits(logits, cfg.top_k, x.dtype)
        want = moe.topk_from_logits(logits.cpu(), cfg.top_k, x.dtype)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        assert got[0][0, 1].tolist() == list(range(cfg.top_k))
        for a, b in zip(moe.sort_dispatch(got[0], cfg.n_experts, cap),
                        moe.sort_dispatch(want[0], cfg.n_experts, cap)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_moe_combine_is_deterministic_on_the_card(cuda):
    """Two runs of the MoE feed-forward (dispatch, expert products,
    combine) on the same input give the same bits, decode and prefill."""
    from repro_torch.models import moe

    cfg, p = _moe_layer(cuda, "mixtral-8x22b")
    g = torch.Generator(device=cuda).manual_seed(5)
    for shape in ((4, 1), (4, 32)):
        x = torch.randn(*shape, cfg.d_model, generator=g, device=cuda).to(torch.bfloat16)
        assert torch.equal(moe.moe_ffn(x, p, cfg), moe.moe_ffn(x, p, cfg))


def _recurrent_layer(arch, key, seed=0):
    """Layer 0's ``key`` subtree of ``arch``'s smoke config on the CPU in
    float32, its constant leaves (token-shift mixes, bonus, norm gains and
    shifts, biases) filled with seeded values."""
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get_smoke_config(arch)
    p = {k: v[0] for k, v in lm.init_params(cfg, seed=seed, device="cpu")["blocks"]["p0"][key]
         .items()}
    g = torch.Generator().manual_seed(seed + 1)
    for k in ("mu_base", "mu_five", "u", "ln_x_g", "ln_x_b", "mu_k", "mu_r", "conv_b",
              "dt_bias", "d_skip"):
        if k in p:
            p[k] = p[k] + 0.3 * torch.randn(p[k].shape, generator=g)
    return cfg, p


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 10, 128])
def test_rwkv_time_and_channel_mix_on_the_card_equal_the_cpu(cuda, s):
    """float32 on both sides, from a fresh and from a nonzero state; the
    card's products sum in other orders."""
    from repro_torch.models import rwkv6

    g = torch.Generator().manual_seed(s)
    for key, fn in (("tm", rwkv6.time_mix), ("cm", rwkv6.channel_mix)):
        cfg, p = _recurrent_layer("rwkv6-3b", key)
        n = cfg.rwkv_head_dim
        x = torch.randn(2, s, cfg.d_model, generator=g)
        st = {"shift": torch.randn(2, cfg.d_model, generator=g)}
        if key == "tm":
            st["wkv"] = torch.randn(2, cfg.d_model // n, n, n, generator=g)
        for state in (None, st):
            want = fn(x, p, cfg, state)
            got = fn(x.to(cuda), {k: v.to(cuda) for k, v in p.items()}, cfg,
                     None if state is None else {k: v.to(cuda) for k, v in state.items()})
            for a, b in zip((got[0], *got[1].values()), (want[0], *want[1].values())):
                assert a.is_cuda and bool(torch.isfinite(a).all())
                torch.testing.assert_close(a.cpu(), b, rtol=0,
                                           atol=MATMUL_RTOL * float(b.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 2, 128])
def test_mamba_layer_on_the_card_equals_the_cpu(cuda, s):
    from repro_torch.models import mamba

    cfg, p = _recurrent_layer("jamba-1.5-large-398b", "mamba")
    g = torch.Generator().manual_seed(s)
    x = torch.randn(2, s, cfg.d_model, generator=g)
    st = {"conv": torch.randn(2, cfg.d_conv - 1, cfg.d_inner, generator=g),
          "ssm": torch.randn(2, cfg.d_inner, cfg.d_state, generator=g)}
    for state in (None, st):
        want = mamba.mamba_layer(x, p, cfg, state)
        on_card = None if state is None else {k: v.to(cuda) for k, v in state.items()}
        got = mamba.mamba_layer(x.to(cuda), {k: v.to(cuda) for k, v in p.items()}, cfg, on_card)
        for a, b in zip((got[0], *got[1].values()), (want[0], *want[1].values())):
            assert a.is_cuda and bool(torch.isfinite(a).all())
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=MATMUL_RTOL * float(b.abs().max()))


@pytest.mark.gpu
def test_empty_inline_arena_launches_nothing_on_the_card(cuda):
    """rwkv6's inline key rule protects no leaf: the single-rail engine's
    arena is empty, and its voltage steps, generate and walk launch no
    kernel; its power report is the reference's single-rail form."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import engine

    cfg = configs.get_smoke_config("rwkv6-3b")
    params = lm.init_params(cfg, seed=0, device=cuda)
    rel = engine.ReliabilityConfig(mode="inline", voltage=1.0,
                                   rails=engine.RailsConfig(start_v=0.62))
    ops.reset_launch_count()
    eng = engine.ServingEngine(cfg, params, rel=rel, max_len=24, device=cuda)
    assert eng._store.n_words == 0
    eng.set_voltage(0.56)
    toks = eng.generate(np.zeros((2, 5), np.int32), 4)
    plain = engine.ServingEngine(cfg, params, rel=None, max_len=24, device=cuda)
    assert np.array_equal(toks, plain.generate(np.zeros((2, 5), np.int32), 4))
    eng.set_voltage(eng.controller.voltage)
    eng.autotune_voltage()
    assert sum(ops.launch_counts().values()) == 0, ops.launch_counts()
    rep = eng.power_report()
    assert rep["codecs"] == {} and np.isfinite(rep["total_w"])


def _family_run(arch, device, seed=0):
    """The smoke config through an inline engine at 0.56 V with host masks
    on ``device``: (prefill logits, 4 greedy steps through the serving
    steps, the step's counters, the fused matmul's launches). vlm cross
    gates are set nonzero (drawn as zeros, the identity)."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import engine, steps

    cfg = configs.get_smoke_config(arch)
    params = lm.init_params(cfg, seed=seed, device="cpu")
    if cfg.family == "vlm":
        for name in ("gate_attn", "gate_ffn"):
            params["blocks"]["p4"][name].fill_(0.55)
    rng = np.random.default_rng(seed)
    shape = (2, cfg.n_codebooks, 6) if cfg.n_codebooks else (2, 6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, shape), device=device)
    img = None
    if cfg.family == "vlm":
        img = torch.from_numpy(rng.standard_normal((2, cfg.n_img_tokens, cfg.d_model))
                               .astype(np.float32)).to(device)
    ops.reset_launch_count()
    eng = engine.ServingEngine(cfg, params, rel=engine.ReliabilityConfig(mode="inline",
                                                                         voltage=1.0),
                               max_len=16, device=device)
    eng.set_voltage(0.56)
    cache = lm.init_cache(cfg, 2, 16, device=device)
    tok, cache = steps.make_prefill_step(cfg)(eng.params, toks, cache, img=img)
    logits, _ = lm.prefill(eng.params, toks, cfg, lm.init_cache(cfg, 2, 16, device=device),
                           img=img)
    out, tok = [tok.cpu()], tok[..., None]
    for i in range(4):
        tok, cache = steps.make_serve_step(cfg)(eng.params, tok, cache, toks.shape[-1] + i)
        out.append(tok[..., 0].cpu())
    return logits.cpu(), torch.stack(out, -1), eng._last_scrub, ops.launch_counts()["ecc_matmul"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_vlm_and_audio_on_the_card_equal_the_cpu(cuda, arch):
    """Image cross-attention and codebook decoding through the fused ECC
    matmul on the card: the CPU's tokens and counters, logits within
    MATMUL_RTOL x max."""
    cl, ct, cs, _ = _family_run(arch, "cpu")
    gl, gt, gs, launches = _family_run(arch, cuda)
    assert launches > 0 and gs == cs and gs.corrected > 0
    assert torch.equal(gt, ct)
    torch.testing.assert_close(gl, cl, rtol=0, atol=MATMUL_RTOL * float(cl.abs().max()))


@pytest.mark.gpu
def test_protected_cross_projection_is_refused_on_the_card(cuda):
    """At n_kv_heads = 4 the cross wk / wv are packed: the prefill raises
    before any kernel launch."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import engine

    cfg = dataclasses.replace(configs.get_smoke_config("llama-3.2-vision-11b"), n_kv_heads=4)
    eng = engine.ServingEngine(cfg, lm.init_params(cfg, seed=0, device=cuda),
                               rel=engine.ReliabilityConfig(mode="inline", voltage=1.0),
                               max_len=16, device=cuda)
    ops.reset_launch_count()
    img = torch.zeros(2, cfg.n_img_tokens, cfg.d_model, device=cuda)
    with pytest.raises(ValueError, match=r"blocks\.p4\.attn\.wk"):
        lm.prefill(eng.params, torch.zeros(2, 4, dtype=torch.long, device=cuda), cfg,
                   lm.init_cache(cfg, 2, 16, device=cuda), img=img)
    assert sum(ops.launch_counts().values()) == 0, ops.launch_counts()


def _train_state(device, seed=0):
    """A tiny float32 trainer state with a bf16 leaf, on ``device``."""
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(64, 96, generator=g),
                       "e": torch.randn(37, 5, generator=g).to(torch.bfloat16)},
            "opt": {"m": {"w": torch.randn(64, 96, generator=g)},
                    "step": torch.tensor(3, dtype=torch.int32)}}


@pytest.mark.gpu
def test_checkpoint_encode_and_decode_on_the_card_equal_the_plain_versions(cuda, tmp_path):
    """Saved from the card, each leaf's check plane is one B4 launch equal
    to the plain encode's; loaded onto the card, each leaf is one B5 launch,
    a flipped bit corrected and two in one word detected."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import quantize
    from repro_torch.models import base

    cpu_state = _train_state("cpu")
    state = base.tree_map(lambda t: t.to(cuda), cpu_state)
    ops.reset_launch_count()
    ckpt.save(str(tmp_path / "card"), 1, state, ecc_protect=True)
    assert ops.launch_counts()["encode"] == 4
    ckpt.save(str(tmp_path / "cpu"), 1, cpu_state, ecc_protect=True)
    for i, (_, leaf) in enumerate(base.flatten(cpu_state)):
        a = np.load(tmp_path / "card" / "step_000001" / f"leaf_{i:05d}.ecc.npz")
        b = np.load(tmp_path / "cpu" / "step_000001" / f"leaf_{i:05d}.ecc.npz")
        lo, hi, _ = quantize.array_to_words(leaf)
        assert np.array_equal(a["parity"], b["parity"])
        assert np.array_equal(a["parity"], ref.encode_ref(lo, hi, "secded72").numpy())
    ops.reset_launch_count()
    back = ckpt.load(str(tmp_path / "card"), 1, state)
    assert ops.launch_counts()["decode"] == 4
    for (_, a), (_, b) in zip(base.flatten(back), base.flatten(state)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    i_w = [k for k, _ in base.flatten(state)].index("['params']['w']")
    leaf = tmp_path / "card" / "step_000001" / f"leaf_{i_w:05d}.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-100] ^= 0x04
    leaf.write_bytes(bytes(raw))
    assert torch.equal(ckpt.load(str(tmp_path / "card"), 1, state)["params"]["w"],
                       state["params"]["w"])
    raw[-8] ^= 0x03
    leaf.write_bytes(bytes(raw))
    with pytest.raises(ckpt.CheckpointCorruption):
        ckpt.load(str(tmp_path / "card"), 1, state)


@pytest.mark.gpu
def test_tiny_train_steps_on_the_card_equal_the_cpu(cuda, tmp_path):
    """Three steps of the tiny trainer from the same weights: the card's
    losses and parameters within the CPU parity tests' tolerances, and no
    kernel launched by a train step."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import base, lm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import Trainer

    cfg = base.ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                           n_kv_heads=2, d_ff=128, vocab=64, head_dim=16)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100),
                     remat="full")
    p0 = lm.init_params(cfg, seed=0, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        tr = Trainer(cfg, tc, TokenPipeline(DataConfig(vocab=64, global_batch=8, seq_len=32)),
                     str(tmp_path / str(dev)), ckpt_every=100, device=dev)
        tr.params = base.tree_map(lambda t: t.to(dev), p0)
        tr.opt_state = adamw.init(tr.params, tc.optimizer)
        ops.reset_launch_count()
        losses = [r["loss"] for r in tr.run(3) if "loss" in r]
        assert sum(ops.launch_counts().values()) == 0, ops.launch_counts()
        out[str(dev)] = (losses, tr.params)
    (lc, pc), (lg, pg) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for (k, a), (_, b) in zip(base.flatten(pg), base.flatten(pc)):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4 * float(b.abs().max()))


MESH_SCHEDULE = [{"attention": 0.55, "mlp": 0.54, "embedding": 1.0},
                 {"attention": 0.54, "mlp": 1.0, "embedding": 0.55}]


def _mesh_store(dev, shard_devices):
    """A mesh store of three leaves (two codec groups, the dected79 one with
    a pad word) with its planes on ``dev`` and one shard on each of
    ``shard_devices``."""
    from repro_torch.configs import shapes
    from repro_torch.core.planestore import PlaneStore
    from repro_torch.core.voltage import PLATFORMS
    from repro_torch.launch.mesh import make_reliability_mesh

    g = np.random.default_rng(5)
    ws = [g.standard_normal(s).astype(np.float32) for s in ((64, 96), (72, 65), (256, 64))]
    keys = ["['blocks']['p0']['attn']['wq']", "['blocks']['p0']['mlp']['w1']", "['embed']"]
    leaves = [ops.pack_ecc_weights(torch.from_numpy(w).to(dev)) for w in ws]
    return PlaneStore(leaves, keys, PLATFORMS["vc707"], seed=3, mask_source="device",
                      domain_key=shapes.domain_of, codecs={"mlp": "dected79"},
                      device=dev, mesh=make_reliability_mesh(len(shard_devices),
                                                             devices=shard_devices))


def _assert_mesh_stores_equal(a, b, schedule):
    """One ``set_rails_sharded`` step of each store: equal planes and
    per-shard counters bit for bit, with faults in them. ``b`` takes
    ``a``'s row factors first, so both draw one field. Returns ``a``'s
    launch counts."""
    import dataclasses

    assert [gr.sharded.pad for gr in a.groups] == [0, 1]
    for ga, gb in zip(a.groups, b.groups):
        gb.sharded.fields = [dataclasses.replace(f, f_row=f.f_row.to(gb.lo.device))
                             for f in ga.sharded.fields]
    ops.reset_launch_count()
    la, sa = a.set_rails_sharded(schedule)
    counts = ops.launch_counts()
    lb, sb = b.set_rails_sharded(schedule)
    for x_, y_ in zip(la, lb):
        for x, y in ((x_.lo, y_.lo), (x_.hi, y_.hi), (x_.parity, y_.parity)):
            assert x.device == a.groups[0].lo.device
            assert torch.equal(x.cpu(), y.cpu())
    for s in range(a.n_shards):
        for d in a.domains:
            assert sa[s][d].counters().tolist() == sb[s][d].counters().tolist(), (s, d)
    assert sa.total().faulty_words > 0
    return counts


@pytest.mark.gpu
def test_two_shard_store_and_kv_scrub_step_on_the_card_equal_the_cpu(cuda):
    """A 2-shard mesh store (two codec groups, a pad word) and a 2-shard KV
    scrub step on the card against the same on the CPU, bit for bit: the
    CPU store takes the card shards' row factors, so both draw one field.
    Each shard launches the field and B2 once per codec group below V_min."""
    from repro_torch.core.kvpages import KVGeometry, KVPageArena
    from repro_torch.core.voltage import PLATFORMS
    from repro_torch.distributed import meshrel
    from repro_torch.launch.mesh import make_reliability_mesh
    from repro_torch.models.base import ModelConfig

    g = np.random.default_rng(5)
    for s in ((64, 96), (72, 65), (256, 64)):
        g.standard_normal(s)  # the store's weights: the KV payloads follow them
    counts = _assert_mesh_stores_equal(_mesh_store(cuda, [cuda] * 2),
                                       _mesh_store("cpu", ["cpu"] * 2), MESH_SCHEDULE)
    # B2 on each (shard, group) slice; the field on three of them: shard 1's
    # dected79 slice holds only mlp words, whose rail there is at 1.0 V
    assert counts["fault_field"] == 3 and counts["inject_scrub_domains"] == 4, counts

    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab=128, head_dim=16)
    geom = KVGeometry.from_config(cfg, page_tokens=4)
    planes = []
    for s in range(2):
        a = KVPageArena(geom, PLATFORMS["vc707"], n_pages=3, seed=11, device=cuda, shard=s)
        payload = torch.from_numpy(g.standard_normal((4, geom.token_f32)).astype(np.float32))
        a.commit_tokens(payload.to(cuda), np.array([0, 0, 1, 2]), np.array([0, 1, 0, 0]))
        a.set_voltage(0.545)
        a.tick()
        planes.append((a.lo, a.hi, a.parity))
    stacked = [torch.cat([p[i] for p in planes]) for i in range(3)]
    table = np.array([[0, 1, 2, 3], [2, 2, 0, 3]], np.int32)
    step = meshrel.make_kv_scrub_step(make_reliability_mesh(2, devices=[cuda] * 2),
                                      geom.words_per_page, planes[0][0].numel(), 4)
    host = [t.to("cpu", copy=True) for t in stacked]
    ok = step(*stacked, table)
    op = meshrel.make_kv_scrub_step(make_reliability_mesh(2, devices=["cpu"] * 2),
                                    geom.words_per_page, planes[0][0].numel(), 4)(*host, table)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(ok, op))
    assert int(op[-1][:, :, 1:3].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("other", ["cpu", "cuda:1"])
def test_mesh_store_with_a_shard_off_the_planes_device_equals_the_cpu(cuda, other):
    """A 2-shard mesh store whose planes lie on the card and whose shard 1
    runs on another device (the CPU, or a second card where there is one,
    as ``make_reliability_mesh()`` places shards on a machine of several
    cards): shard 1 draws its field and runs B2 there on a copy of its clean
    slices, and its faulty slices and counters are copied back. Planes and
    counters equal the all-CPU store's bit for bit."""
    if other.startswith("cuda") and torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    mixed = _mesh_store(cuda, [cuda, other])
    assert mixed.mesh.device_of(1) == torch.device(other)
    counts = _assert_mesh_stores_equal(mixed, _mesh_store("cpu", ["cpu"] * 2), MESH_SCHEDULE)
    # shard 0 launches the field and B2 on both groups; shard 1 on its
    # secded72 group alone (its dected79 slice holds mlp words at 1.0 V),
    # through the kernels on a second card and the plain versions on the CPU
    on_card = 1 if other.startswith("cuda") else 0
    assert counts["fault_field"] == 2 + on_card, counts
    assert counts["inject_scrub_domains"] == 2 + 2 * on_card, counts
