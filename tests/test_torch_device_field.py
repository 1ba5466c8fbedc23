"""The port's device fault field (``DeviceFaultField``, ``interval_masks``)
through the fault-field kernel's plain version on the CPU: the Philox4x32-10
against Random123's known-answer vectors, the 16-bit-split multiply against
Python integers, and the reference's device-field tests
(tests/test_inject_scrub.py) with their bounds, against the port's host
``FaultField`` and the reference's own device field."""

import numpy as np
import pytest
import torch

from repro.core.faultsim import DeviceFaultField as JDeviceField
from repro.core.voltage import PLATFORMS as JPLATFORMS
from repro_torch.core import faultsim as tfs
from repro_torch.core.voltage import PLATFORMS
from repro_torch.kernels import ops, ref

M32 = 0xFFFFFFFF
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain fault field is many small int64 torch ops: under
    pytest-xdist, workers that each run a thread per core contend for the
    cores (30x slower); one intra-op thread a worker avoids that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_CHECKS = (1, 8, 15, 24)  # parity65, secded72, dected79, ileave88


def _np(masks):
    """(lo, hi, check) tensors -> numpy uint32 / check arrays."""
    lo, hi, chk = masks
    return lo.numpy().view(np.uint32), hi.numpy().view(np.uint32), chk.numpy()


def _flips(masks) -> np.ndarray:
    lo, hi, chk = _np(masks)
    return tfs._popcount32(lo) + tfs._popcount32(hi) + tfs._popcount32(chk.astype(np.uint32))


# -- the Philox4x32-10 of the kernel's plain version --------------------------


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    out = ref.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(o) for o in out) == want


def _philox_int(ctr, key):
    """Philox4x32-10 on Python integers (the definition, no int64 limits)."""
    c, (k0, k1) = list(ctr), key
    for _ in range(10):
        p0, p1 = ref.PHILOX_M[0] * c[0], ref.PHILOX_M[1] * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1, p0 & M32]
        k0, k1 = (k0 + ref.PHILOX_W[0]) & M32, (k1 + ref.PHILOX_W[1]) & M32
    return c


def test_mulhilo32_against_python_ints():
    rng = np.random.default_rng(0)
    vals = [0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, M32,
            *rng.integers(0, 2**32, 40, dtype=np.uint64).tolist()]
    a = torch.tensor(vals, dtype=torch.int64)
    for m in [0, 1, M32, 0x80000000, *ref.PHILOX_M, *rng.integers(0, 2**32, 6).tolist()]:
        hi, lo = ref.mulhilo32(a, int(m))
        assert hi.tolist() == [(v * int(m)) >> 32 for v in vals], m
        assert lo.tolist() == [(v * int(m)) & M32 for v in vals], m
    # both operands tensors
    hi, lo = ref.mulhilo32(a, a.flip(0))
    want = [x * y for x, y in zip(vals, vals[::-1])]
    assert hi.tolist() == [w >> 32 for w in want] and lo.tolist() == [w & M32 for w in want]


@pytest.mark.parametrize("n_check", N_CHECKS)
def test_plain_field_follows_its_definition(n_check):
    """Each mask bit against Python-integer Philox at counter (w lo, w hi,
    b // 4, 0), threshold uint32(clip(rate f, 0, 0.5) 2^32), at word
    indices across the 2^32 boundary (the counter's second word)."""
    rng = np.random.default_rng(n_check)
    f = torch.from_numpy(rng.lognormal(0.0, 1.5, 6).astype(np.float32))
    f[0] = 1e9  # clipped at P_MAX
    rate, key, base = 0.04, 0x0123456789ABCDEF, 2**32 - 3
    lo, hi, chk = ref.fault_field_ref(f, rate, key, n_check, base=base)
    for i in range(6):
        p = min(max(np.float32(rate) * np.float32(f[i].item()), np.float32(0)), np.float32(0.5))
        thresh = int(np.float32(p) * np.float32(2**32))
        w = base + i
        r = [x for g in range((67 + n_check) // 4)
             for x in _philox_int((w & M32, w >> 32, g, 0), (key & M32, key >> 32))]
        bits = [int(r[b] < thresh) for b in range(64 + n_check)]
        word = lambda bs: sum(b << j for j, b in enumerate(bs))
        assert int(lo[i]) & M32 == word(bits[:32])
        assert int(hi[i]) & M32 == word(bits[32:64])
        assert int(chk[i]) == word(bits[64:])
    assert chk.dtype == (torch.uint8 if n_check <= 8 else torch.int32)


# -- the reference's device-field tests, ported ----------------------------------


@pytest.mark.parametrize("voltage", [0.56, 0.55, 0.54])
def test_device_faultfield_statistics_vs_oracle(voltage):
    plat = PLATFORMS["vc707"]
    n = 1 << 18
    hm = tfs.FaultField(plat, n, seed=11).masks(voltage)
    dflips = _flips(tfs.DeviceFaultField(plat, n, seed=11, device=CPU).masks(voltage))
    h_total, d_total = hm.total_flips(), int(dflips.sum())
    assert h_total > 100  # meaningful sample at these voltages
    # same model, different PRNG stream: totals within sampling noise
    # (lognormal row clustering inflates variance ~e^{sigma^2} over Poisson)
    assert 0.6 < d_total / h_total < 1.6, (voltage, h_total, d_total)
    h_counts = hm.flip_counts()
    h_frac = (h_counts >= 2).sum() / max((h_counts >= 1).sum(), 1)
    d_frac = (dflips >= 2).sum() / max((dflips >= 1).sum(), 1)
    assert abs(h_frac - d_frac) < 0.1, (voltage, h_frac, d_frac)


def test_device_faultfield_statistics_vs_reference_device_field():
    """The reference's device field (JAX threefry) and the port's: one
    model, two streams, held to the same bounds at 0.55 V."""
    n, v = 1 << 18, 0.55
    j = JDeviceField(JPLATFORMS["vc707"], n, seed=11).masks(v)
    jflips = sum(tfs._popcount32(np.asarray(x).astype(np.uint32)) for x in j)
    tflips = _flips(tfs.DeviceFaultField(PLATFORMS["vc707"], n, seed=11, device=CPU).masks(v))
    assert 0.6 < tflips.sum() / jflips.sum() < 1.6
    frac = lambda c: (c >= 2).sum() / max((c >= 1).sum(), 1)
    assert abs(frac(jflips) - frac(tflips)) < 0.1


def test_faultfield_public_api_and_device_bridge():
    """sweep_histogram stays on the host field; device_field bridges across."""
    plat = PLATFORMS["vc707"]
    host = tfs.FaultField(plat, 4096, seed=2)
    hist = host.sweep_histogram([0.8, 0.54])
    assert hist[0]["faulty_bits"] == 0  # inside the guardband
    assert hist[1]["faulty_bits"] > 0
    assert hist[1]["faulty_bits"] == host.masks(0.54).total_flips()
    dev = host.device_field(device=CPU)
    assert isinstance(dev, tfs.DeviceFaultField)
    assert (dev.n_words, dev.seed, dev.n_check) == (host.n_words, host.seed, host.n_check)


def test_device_faultfield_multichunk():
    """Drawn in chunks (the plain version's bounded transients):
    deterministic, FIP across chunk boundaries, later chunks populated."""
    plat = PLATFORMS["vc707"]
    n = 3000
    f = tfs.DeviceFaultField(plat, n, seed=9, chunk_words=1024, device=CPU)  # 3 chunks
    a, b, hi_v = (_np(f.masks(v)) for v in (0.54, 0.54, 0.56))
    for x, y, z in zip(a, b, hi_v):
        assert x.shape == (n,)
        assert np.array_equal(x, y)  # repeated calls identical
        assert not np.any(z & ~x)  # FIP holds under chunking
    assert a[0][2048:].any() or a[1][2048:].any()  # last chunk populated


def test_device_faultfield_fip():
    """Fault Inclusion Property: lower rail => superset fault pattern."""
    plat = PLATFORMS["vc707"]
    dev = tfs.DeviceFaultField(plat, 1 << 16, seed=5, device=CPU)
    prev = None
    for v in (0.58, 0.56, 0.55, 0.54):
        cur = _np(dev.masks(v))
        if prev is not None:
            for p, c in zip(prev, cur):
                assert not np.any(p & ~c), v
        prev = cur
    # inside the guardband: zero faults
    for m in _np(dev.masks(0.8)):
        assert not m.any()


# -- the port's own properties of the draw ---------------------------------------


def test_uniform_rate_vector_equals_scalar_path():
    plat = PLATFORMS["vc707"]
    f = tfs.DeviceFaultField(plat, 5000, seed=3, n_check=15, device=CPU)
    rate = plat.fault_rate(0.55)
    scalar = f.masks(0.55)
    for rates in (np.full(5000, rate, np.float32), torch.full((5000,), rate)):
        assert all(torch.equal(a, b) for a, b in zip(f.masks_for_rates(rates), scalar))
    # per-word rates: a zero-rate range draws nothing, the rest as the scalar
    rates = torch.full((5000,), rate)
    rates[1000:2500] = 0.0
    mixed = f.masks_for_rates(rates)
    for m, s in zip(mixed, scalar):
        assert not m[1000:2500].any()
        assert torch.equal(m[:1000], s[:1000]) and torch.equal(m[2500:], s[2500:])
    with pytest.raises(ValueError, match="rates"):
        f.masks_for_rates(np.full(4999, rate, np.float32))


def test_zero_rate_makes_zero_masks_without_a_draw(monkeypatch):
    f = tfs.DeviceFaultField(PLATFORMS["vc707"], 777, seed=1, n_check=24, device=CPU)
    monkeypatch.setattr(ops, "fault_field", lambda *a, **k: pytest.fail("drew masks"))
    lo, hi, chk = f.masks(1.0)
    assert lo.shape == hi.shape == chk.shape == (777,)
    assert chk.dtype == torch.int32 and not (lo.any() or hi.any() or chk.any())


def test_data_planes_equal_across_n_check():
    plat = PLATFORMS["vc707"]
    masks = {nc: tfs.DeviceFaultField(plat, 4000, seed=7, n_check=nc, device=CPU).masks(0.54)
             for nc in N_CHECKS}
    for nc, (lo, hi, chk) in masks.items():
        assert torch.equal(lo, masks[8][0]) and torch.equal(hi, masks[8][1])
        assert chk.dtype == (torch.uint8 if nc <= 8 else torch.int32)
        assert int(chk.max()) < (1 << nc) and chk.any()
    # the check planes of wider codes extend the narrower ones' bits
    assert torch.equal(masks[24][2] & 0x7FFF, masks[15][2])
    assert torch.equal((masks[15][2] & 0xFF).to(torch.uint8), masks[8][2])
    assert torch.equal(masks[8][2] & 1, masks[1][2])


def test_masks_equal_across_chunk_words():
    plat = PLATFORMS["vc707"]
    ref_masks = tfs.DeviceFaultField(plat, 5003, seed=4, device=CPU).masks(0.55)
    for cw in (13, 1000, 4096, 1 << 20):
        got = tfs.DeviceFaultField(plat, 5003, seed=4, chunk_words=cw, device=CPU).masks(0.55)
        assert all(torch.equal(a, b) for a, b in zip(got, ref_masks)), cw


def test_field_is_deterministic_per_seed_and_keeps_its_row_factor():
    plat = PLATFORMS["vc707"]
    a = tfs.DeviceFaultField(plat, 3000, seed=5, device=CPU)
    b = tfs.DeviceFaultField(plat, 3000, seed=5, device=CPU)
    c = tfs.DeviceFaultField(plat, 3000, seed=6, device=CPU)
    assert torch.equal(a.f_row, b.f_row) and not torch.equal(a.f_row, c.f_row)
    assert abs(float(a.f_row.mean()) - 1.0) < 0.2  # E[f] = 1
    assert all(torch.equal(x, y) for x, y in zip(a.masks(0.54), b.masks(0.54)))
    assert not torch.equal(a.masks(0.54)[0], c.masks(0.54)[0])


def test_device_field_and_interval_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfs.DeviceFaultField(PLATFORMS["vc707"], 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfs.interval_masks(3, 1, 100, 1e-3, 0.5)


@pytest.mark.parametrize("n_check", N_CHECKS)
def test_interval_masks_are_a_field_per_interval(n_check):
    """An interval's masks are the fault field keyed by (seed ^ 0xCACE,
    interval): its row factor from that generator seed, its bits from the
    salted Philox key."""
    seed, interval, n, rate, sigma = 5, 3, 4000, 2e-3, 0.9
    got = tfs.interval_masks(seed, interval, n, rate, sigma, n_check, device=CPU)
    key = ((seed ^ 0xCACE) << 32) | interval
    f_row = tfs.row_factor(n, sigma, key, CPU)
    want = ref.fault_field_ref(f_row, rate, tfs.philox_key(key), n_check)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].any()
