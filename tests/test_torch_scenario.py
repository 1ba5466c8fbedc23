"""The environment scenario matrix in the port (``repro_torch.core.scenario``)
against the reference's (``repro.core.scenario``): the pure functions float
for float, the host burst field bit for bit, the plane arena, the KV arena
and the engine under an environment bit for bit (host masks, or the same
numpy masks handed to both packages), and the device field's burst
expansion through the fault-field kernel's plain version: its definition
on Python integers, its stream properties and its statistics against the
host burst field."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _hypothesis_compat import given, settings, st
from conftest import tiny_cfg
from repro.configs import shapes as jshapes
from repro.core import controller as jctl
from repro.core import faultsim as jfs
from repro.core import kvpages as jkv
from repro.core import planestore as jps
from repro.core import scenario as jsc
from repro.core import telemetry as jtel
from repro.core import voltage as jv
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.serving.engine import FaultModelConfig as JFault
from repro.serving.engine import RailsConfig as JRails
from repro.serving.engine import ReliabilityConfig as JRel
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import shapes as tshapes
from repro_torch.core import controller as tctl
from repro_torch.core import faultsim as tfs
from repro_torch.core import kvpages as tkv
from repro_torch.core import planestore as tps
from repro_torch.core import scenario as tsc
from repro_torch.core import telemetry as ttel
from repro_torch.core import voltage as tv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import fault_field as tff
from repro_torch.kernels import ref as tref
from repro_torch.models import base as tbase
from repro_torch.serving import engine as teng

M32 = 0xFFFFFFFF
CPU = torch.device("cpu")
N_CHECKS = (1, 8, 15, 24)  # parity65, secded72, dected79, ileave88
ENVS = sorted(tsc.ENVIRONMENTS)
# each environment's burst, then one profile per anchor class
BURSTS = {
    **{f"env_{e}": (lambda e: (lambda m: m.ENVIRONMENTS[e].burst))(e) for e in ENVS},
    **{cls: (lambda c: (lambda m: m.BurstProfile(**{c: 1.0})))(cls)
       for cls in ("double_adjacent", "triple_adjacent", "random_double", "word_adjacent")},
}
PROF = tv.PLATFORMS["vc707"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain fault field is many small int64 torch ops: under
    pytest-xdist, workers that each run a thread per core contend for the
    cores (30x slower); one intra-op thread a worker avoids that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(mod, env):
    """The same environment argument in either package."""
    if isinstance(env, tuple):  # a custom profile: (name, multiplier, burst kwargs, sigma, tau)
        name, mult, burst, sigma, tau = env
        return mod.EnvironmentProfile(name, mult, mod.BurstProfile(**burst), sigma, tau)
    return env


CUSTOM = ("lab", 7.5, {"double_adjacent": 0.3, "word_adjacent": 0.2}, 0.3, 40.0)


def _np(masks):
    lo, hi, chk = masks
    return lo.numpy().view(np.uint32), hi.numpy().view(np.uint32), chk.numpy()


def _flips(masks) -> np.ndarray:
    lo, hi, chk = _np(masks)
    return tfs._popcount32(lo) + tfs._popcount32(hi) + tfs._popcount32(chk.astype(np.uint32))


# -- the pure functions ------------------------------------------------------------


@pytest.mark.parametrize("env", [None, "consumer", "avionics", "space", CUSTOM])
@pytest.mark.parametrize("drift", [None, 0.0, 0.5])
def test_resolve_equals_the_reference(env, drift):
    j, t = jsc.resolve(_env(jsc, env), drift=drift), tsc.resolve(_env(tsc, env), drift=drift)
    assert (j is None) == (t is None)
    if t is not None:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.burst.enabled, t.burst.needs_class_draw, t.burst.class_thresholds()) == (
            j.burst.enabled, j.burst.needs_class_draw, j.burst.class_thresholds())


def test_unknown_environment_and_bad_bursts_raise_as_in_the_reference():
    for mod in (jsc, tsc):
        with pytest.raises(AssertionError):
            mod.resolve("mars")
        with pytest.raises(AssertionError):
            mod.BurstProfile(double_adjacent=0.6, triple_adjacent=0.5)
        with pytest.raises(AssertionError):
            mod.BurstProfile(word_adjacent=1.5)
    assert tsc.MBU_DISTRIBUTION == tsc.BurstProfile(**dataclasses.asdict(jsc.MBU_DISTRIBUTION))


@pytest.mark.parametrize("platform", sorted(tv.PLATFORMS))
def test_scale_profile_and_scenario_voltage_equal_the_reference(platform):
    jp, tp = jv.PLATFORMS[platform], tv.PLATFORMS[platform]
    for env in [None, *ENVS, CUSTOM]:
        je, te = jsc.resolve(_env(jsc, env)), tsc.resolve(_env(tsc, env))
        for target in (1e-4, 1e-6, 1e-2):
            assert tsc.scenario_voltage(tp, te, target) == jsc.scenario_voltage(jp, je, target)
        if te is None:
            continue
        js_, ts_ = je.scale_profile(jp), te.scale_profile(tp)
        assert dataclasses.asdict(ts_) == dataclasses.asdict(js_)
        for v in (1.0, 0.62, 0.6, 0.58, 0.56, 0.54):
            assert ts_.fault_rate(v) == js_.fault_rate(v)
    assert tsc.scenario_voltage(tp, None) == jsc.scenario_voltage(jp, None)


def test_shard_aging_z_and_multiplier_equal_the_reference():
    envs = [None, *ENVS, CUSTOM, "drift"]
    for seed in (0, 5):
        for shard in range(8):
            assert tsc.shard_aging_z(shard, seed) == jsc.shard_aging_z(shard, seed)
            for env in envs:
                if env == "drift":  # a bare drift: the neutral environment
                    je, te = jsc.resolve(None, drift=0.5), tsc.resolve(None, drift=0.5)
                else:
                    je, te = jsc.resolve(_env(jsc, env)), tsc.resolve(_env(tsc, env))
                for age in (0, 1, 150, 300):
                    assert tsc.aging_multiplier(shard, age, te, seed) == \
                        jsc.aging_multiplier(shard, age, je, seed), (seed, shard, env, age)
    # drift 0 collapses every multiplier to exactly 1
    assert tsc.aging_multiplier(3, 300, tsc.resolve("space", drift=0.0), 5) == 1.0


@settings(deadline=None, max_examples=10)
@given(st.integers(min_value=0, max_value=10_000),
       st.sampled_from(sorted(BURSTS)), st.sampled_from(N_CHECKS))
def test_expand_bursts_equals_the_reference(seed, burst, n_check):
    rng = np.random.default_rng(seed)
    nb, m = 64 + n_check, 512
    faulty = rng.random((nb, m)) < 0.01
    cu = rng.random((nb, m)).astype(np.float32)
    wu = rng.random((nb, m)).astype(np.float32)
    eb = rng.integers(0, nb, m)
    want = jsc.expand_bursts(faulty, BURSTS[burst](jsc), cu, wu, eb, xp=np)
    got = tsc.expand_bursts(faulty, BURSTS[burst](tsc), cu, wu, eb, xp=np)
    np.testing.assert_array_equal(got, want)
    assert tsc.expand_bursts(faulty, tsc.BurstProfile(), xp=np) is faulty


# -- the host burst field ------------------------------------------------------------


@pytest.mark.parametrize("n_check", N_CHECKS)
@pytest.mark.parametrize("burst", sorted(BURSTS))
def test_host_burst_field_bit_identical(burst, n_check):
    """Per-chunk draws in the reference's order (class, word, companion),
    chunks below n so word-adjacent spills stop at chunk edges."""
    n, v = 2500, 0.55
    j = jfs.FaultField(jv.PLATFORMS["vc707"], n, seed=4, chunk_words=1000, n_check=n_check,
                       burst=BURSTS[burst](jsc)).masks(v)
    t = tfs.FaultField(PROF, n, seed=4, chunk_words=1000, n_check=n_check,
                       burst=BURSTS[burst](tsc)).masks(v)
    for a, b in zip((t.lo, t.hi, t.parity), (j.lo, j.hi, j.parity)):
        np.testing.assert_array_equal(a, b)
    assert t.parity.dtype == j.parity.dtype
    base = tfs.FaultField(PROF, n, seed=4, chunk_words=1000, n_check=n_check).masks(v)
    assert t.total_flips() > base.total_flips()  # the expansion added bits


def test_host_burst_field_on_a_thread_pool_and_its_histogram():
    burst = tsc.ENVIRONMENTS["space"].burst
    fields = [tfs.FaultField(PROF, 3000, seed=s, chunk_words=700, burst=burst) for s in (1, 2)]
    pooled = tfs.gather_masks([(f, 0.55) for f in fields], workers=4)
    for f, m in zip(fields, pooled):
        one = tfs.FaultField(PROF, 3000, seed=f.seed, chunk_words=700, burst=burst)
        s = tfs.gather_masks([(one, 0.55)], workers=1)[0]
        for a, b in zip((m.lo, m.hi, m.parity), (s.lo, s.hi, s.parity)):
            np.testing.assert_array_equal(a, b)
    vs = [0.8, 0.56, 0.54]
    j = jfs.FaultField(jv.PLATFORMS["vc707"], 3000, seed=1, chunk_words=700,
                       burst=jsc.ENVIRONMENTS["space"].burst).sweep_histogram(vs)
    assert fields[0].sweep_histogram(vs) == j
    assert tfs.FaultField(PROF, 10, burst=tsc.BurstProfile()).burst is None
    dev = fields[0].device_field(device=CPU)
    assert dev.burst == burst and dev.n_check == fields[0].n_check


# -- the device burst field: the kernel's plain version ----------------------------


def _philox_int(ctr, key):
    c, (k0, k1) = list(ctr), key
    for _ in range(10):
        p0, p1 = tref.PHILOX_M[0] * c[0], tref.PHILOX_M[1] * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1, p0 & M32]
        k0, k1 = (k0 + tref.PHILOX_W[0]) & M32, (k1 + tref.PHILOX_W[1]) & M32
    return c


def _spec_word(w, thresh, key, n_check, th):
    """Word w's burst flips on Python integers, from the stream that
    csrc/fault_field.cu documents; ``thresh(i)`` is word i's threshold."""
    nb, k = 64 + n_check, (key & M32, key >> 32)
    draw = lambda i, lane: [x for g in range((nb + 3) // 4)
                            for x in _philox_int((i & M32, i >> 32, g, lane), k)][:nb]
    anchors = lambda i: [r < thresh(i) for r in draw(i, 0)]
    t3, t2, trd, twa = th
    a = anchors(w)
    out = list(a)
    cls, rd = draw(w, 1), False
    for b in range(nb):
        if a[b]:
            for shift, t in ((1, t2), (2, t3)):
                if cls[b] < t and b + shift < nb:
                    out[b + shift] = True
            rd |= t2 <= cls[b] < trd
    if rd:
        out[(_philox_int((w & M32, w >> 32, 0, 3), k)[0] * nb) >> 32] = True
    if twa and w > 0:
        prev, wd = anchors(w - 1), draw(w - 1, 2)
        for b in range(nb):
            out[b] |= prev[b] and wd[b] < twa
    return out


@pytest.mark.parametrize("n_check", N_CHECKS)
def test_plain_burst_field_follows_its_definition(n_check):
    """Dense anchors and large class probabilities, words across the 2^32
    boundary, one word of the slice drawn only for its spill."""
    rng = np.random.default_rng(n_check)
    n = 7
    f = torch.from_numpy(rng.lognormal(0.0, 1.0, n).astype(np.float32))
    rates = torch.from_numpy(rng.choice([0.0, 0.03, 0.08], n).astype(np.float32))
    burst = tsc.BurstProfile(double_adjacent=0.3, triple_adjacent=0.2, random_double=0.3,
                             word_adjacent=0.5)
    th = tref.burst_thresholds(burst)
    assert th == tuple(int(np.floor(p * 2**32)) for p in (0.2, 0.5, 0.8, 0.5))
    key, base = 0x0123456789ABCDEF, 2**32 - 4

    def thresh(i):
        p = np.float32(rates[i - base].item()) * np.float32(f[i - base].item())
        return int(np.float32(min(max(p, np.float32(0)), np.float32(0.5))) * np.float32(2**32))

    lo, hi, chk = tref.fault_field_ref(f, rates, key, n_check, base=base, burst=th, lead=1)
    assert lo.shape == (n - 1,)
    word = lambda bs: sum(int(b) << j for j, b in enumerate(bs))
    extra = 0
    for i in range(1, n):
        bits = _spec_word(base + i, thresh, key, n_check, th)
        assert int(lo[i - 1]) & M32 == word(bits[:32]), i
        assert int(hi[i - 1]) & M32 == word(bits[32:64]), i
        assert int(chk[i - 1]) == word(bits[64:]), i
        plain = tref.fault_field_ref(f[i:i + 1], rates[i:i + 1], key, n_check, base=base + i)
        extra += sum(bin(int(a) & M32).count("1") for a in (lo[i - 1], hi[i - 1], chk[i - 1]))
        extra -= sum(bin(int(a) & M32).count("1") for a in plain)
    assert extra > 0  # the bursts added bits
    # word 0 of a field gets no spill
    got = tref.fault_field_ref(f[:2], torch.full((2,), 0.08), key, n_check, burst=th)
    spec = _spec_word(0, lambda i: int(np.float32(min(0.08 * f[i].item(), 0.5)) * 2**32),
                      key, n_check, th)
    assert int(got[0][0]) & M32 == word(spec[:32])


def test_burst_thresholds_cover_always_and_never():
    assert tref.burst_thresholds(None) == tref.NO_BURST == (0, 0, 0, 0)
    assert tref.burst_thresholds(tsc.BurstProfile(word_adjacent=1.0)) == (0, 0, 0, 2**32)
    assert tref.burst_thresholds(tsc.BurstProfile(double_adjacent=1.0)) == (0, 2**32, 2**32, 0)


MBU = tsc.MBU_DISTRIBUTION


def _field(n, seed=5, burst=MBU, n_check=8, chunk_words=None):
    return tfs.DeviceFaultField(PROF, n, seed=seed, n_check=n_check, burst=burst,
                                chunk_words=chunk_words, device=CPU)


@pytest.mark.parametrize("n_check", N_CHECKS)
def test_device_burst_field_replays_and_holds_the_burst_free_masks(n_check):
    n, v = 4000, 0.55
    f = _field(n, n_check=n_check, burst=tsc.ENVIRONMENTS["space"].burst)
    a, b = f.masks(v), f.masks(v)
    again = _field(n, n_check=n_check, burst=tsc.ENVIRONMENTS["space"].burst).masks(v)
    base = _field(n, n_check=n_check, burst=None).masks(v)
    for x, y, z, w in zip(a, b, again, base):
        assert torch.equal(x, y) and torch.equal(x, z)
        assert torch.equal(x & w, w)  # the anchors stay: expansion ORs
    assert _flips(a).sum() > _flips(base).sum()
    assert _field(10, burst=tsc.BurstProfile()).burst is None


def test_device_burst_field_fip():
    f = _field(1 << 14, burst=tsc.ENVIRONMENTS["avionics"].burst)
    prev = None
    for v in (0.58, 0.57, 0.56, 0.55, 0.54):
        cur = _np(f.masks(v))
        if prev is not None:
            for p, c in zip(prev, cur):
                assert not np.any(p & ~c), v
        prev = cur
    assert not any(m.any() for m in f.masks(0.8))


def test_device_burst_uniform_rate_vector_equals_scalar():
    f = _field(5000, n_check=15, burst=tsc.BurstProfile(double_adjacent=0.2, word_adjacent=0.5))
    rate = PROF.fault_rate(0.55)
    scalar = f.masks(0.55)
    for rates in (np.full(5000, rate, np.float32), torch.full((5000,), rate)):
        assert all(torch.equal(a, b) for a, b in zip(f.masks_for_rates(rates), scalar))


@pytest.mark.parametrize("n_check", (8, 24))
def test_device_burst_field_equal_across_chunk_words(n_check):
    """A chunk after the first draws the word before it for its spill, so
    the masks do not depend on the chunking; dense per-word rates with
    zero-rate runs, spills from and into words at rate 0."""
    burst = tsc.BurstProfile(double_adjacent=0.2, triple_adjacent=0.1, random_double=0.2,
                             word_adjacent=0.6)
    rng = np.random.default_rng(n_check)
    n = 9000
    rates = torch.from_numpy(rng.choice([0.0, 0.0, 2e-3, 2e-2], n).astype(np.float32))
    want = _field(n, n_check=n_check, burst=burst).masks_for_rates(rates)
    assert _flips(want).sum() > 1000
    for cw in (4097, tops.FIELD_CPU_CHUNK):
        got = _field(n, n_check=n_check, burst=burst, chunk_words=cw).masks_for_rates(rates)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), cw
    for cw in (1, 3):  # small chunks: the first 200 words
        short = _field(200, n_check=n_check, burst=burst, chunk_words=cw)
        short.f_row = want_f = _field(n, n_check=n_check, burst=burst).f_row[:200]
        got = short.masks_for_rates(rates[:200])
        ref = tops.fault_field(want_f, rates[:200], short.key, n_check, burst=burst)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), cw
        assert all(torch.equal(a, b[:200]) for a, b in zip(got, want)), cw
        assert _flips(got).sum() > 50
    # the zero-rate words drew nothing of their own, but took spills
    zero = (rates == 0).numpy()
    spilled = _flips(want)[zero]
    assert spilled.any()


def test_word_adjacent_spill_and_its_truncation_at_the_field_ends():
    """word_adjacent = 1: every anchor repeats in the next word, so word w's
    masks are its anchors OR word w - 1's; word 0 has only its own, and the
    last word's anchors go nowhere."""
    n = 3000
    rates = torch.full((n,), 0.01)
    rates[-1] = 0.4  # the last word is anchored for sure
    burst = _field(n, burst=tsc.BurstProfile(word_adjacent=1.0)).masks_for_rates(rates)
    base = _field(n, burst=None).masks_for_rates(rates)
    for got, anc in zip(burst, base):
        assert torch.equal(got[0], anc[0])
        assert torch.equal(got[1:], anc[1:] | anc[:-1])
    assert any(bool(a[-1]) for a in base)


RUN = tff.RUN_WORDS
RUN_EDGE_SIZES = (1, 31, 32, 33, RUN - 1, RUN, RUN + 1, 3 * RUN + 5)


def test_run_words_equals_the_burst_kernels_run():
    """kernels/fault_field.py RUN_WORDS is the burst kernel's kRunWords =
    32 kRunIters - 1, read from the CUDA source."""
    src = (Path(tff.__file__).parent / "csrc" / "fault_field.cu").read_text()
    iters = int(re.search(r"constexpr int kRunIters = (\d+);", src).group(1))
    assert "constexpr int kRunWords = 32 * kRunIters - 1;" in src
    assert RUN == 32 * iters - 1


@pytest.mark.parametrize("n", RUN_EDGE_SIZES)
@pytest.mark.parametrize("n_check", N_CHECKS)
def test_plain_field_in_runs_draws_each_runs_halo(n_check, n):
    """The plain field drawn in chunks of the burst kernel's run equals the
    whole field's single draw under word_adjacent = 1, with the word before
    each run boundary (the kernel's halo) and the run's first word in turn
    at rate 0 and at another rail's rate: the spill into a run's first word
    is the halo word's anchors at the halo's own rate, and nothing else."""
    rng = np.random.default_rng(n)
    f = torch.from_numpy(rng.lognormal(0.0, 0.9, n).astype(np.float32))
    key = 0x0DDC0FFEE0 + n
    th = tref.burst_thresholds(tsc.BurstProfile(word_adjacent=1.0))
    anchored = 0
    for where, value in ((None, None), (-1, 0.0), (-1, 0.03), (0, 0.0), (0, 0.03)):
        rates = torch.full((n,), 0.1)
        if where is not None:
            rates[RUN + where::RUN] = value
        whole = tref.fault_field_ref(f, rates, key, n_check, burst=th)
        runs = tref.fault_field_plain(f, rates, key, n_check, th, chunk_words=RUN)
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(runs, whole))
        own = [tref.fault_field_ref(f[s:s + RUN], rates[s:s + RUN], key, n_check, base=s,
                                    burst=th) for s in range(0, n, RUN)]
        free = tref.fault_field_ref(f, rates, key, n_check)
        for s, chunk in zip(range(0, n, RUN), own):
            # inside a run the spills are the run's own; into its first word
            # the halo's anchors (word 0 of the field has no halo)
            halo = [m[s - 1] if s else torch.zeros_like(m[0]) for m in free]
            for m, c, h in zip(whole, chunk, halo):
                assert torch.equal(m[s + 1:s + RUN], c[1:]), (s, where, value)
                assert int(m[s]) == int(c[0] | h), (s, where, value)
            anchored += s > 0 and any(int(h) != 0 for h in halo)
    assert anchored > 0 or n <= RUN


def test_device_burst_histogram_matches_the_configured_distribution():
    """The reference's bounds (tests/test_burst_scenarios.py), measured
    against the burst-free anchors of the same key: sparse anchors, class
    draws only."""
    burst = tsc.BurstProfile(double_adjacent=0.12, triple_adjacent=0.02, random_double=0.01)
    n = 1 << 16
    rates = torch.full((n,), 3e-4)
    out = _flips(_field(n, seed=0, burst=burst).masks_for_rates(rates))
    anchors = _flips(_field(n, seed=0, burst=None).masks_for_rates(rates))
    single = anchors == 1
    n1 = int(single.sum())
    assert n1 > 800
    frac2 = float((out[single] == 2).sum()) / n1
    frac3 = float((out[single] == 3).sum()) / n1
    assert 0.08 < frac2 < 0.18, frac2
    assert 0.005 < frac3 < 0.045, frac3
    extra, n_anchors = int(out.sum() - anchors.sum()), int(anchors.sum())
    assert 0.12 * n_anchors < extra < 0.22 * n_anchors, (extra, n_anchors)


@pytest.mark.parametrize("env,v", [("consumer", 0.55), ("space", 0.56)])
def test_device_burst_statistics_vs_host_burst_field(env, v):
    burst = tsc.ENVIRONMENTS[env].burst
    n = 1 << 17
    hc = tfs.FaultField(PROF, n, seed=11, burst=burst).masks(v).flip_counts()
    dc = _flips(_field(n, seed=11, burst=burst).masks(v))
    assert hc.sum() > 100
    assert 0.6 < dc.sum() / hc.sum() < 1.6, (int(dc.sum()), int(hc.sum()))
    frac = lambda c: (c >= 2).sum() / max((c >= 1).sum(), 1)
    assert abs(frac(hc) - frac(dc)) < 0.1, (frac(hc), frac(dc))


def test_interval_masks_take_the_burst():
    seed, interval, n, rate, sigma = 5, 3, 4000, 2e-3, 0.9
    burst = tsc.ENVIRONMENTS["avionics"].burst
    got = tfs.interval_masks(seed, interval, n, rate, sigma, 8, device=CPU, burst=burst)
    key = ((seed ^ 0xCACE) << 32) | interval
    f_row = tfs.row_factor(n, sigma, key, CPU)
    want = tops.fault_field(f_row, rate, tfs.philox_key(key), 8, burst=burst)
    base = tfs.interval_masks(seed, interval, n, rate, sigma, 8, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a & b, b) for a, b in zip(got, base))
    assert not all(torch.equal(a, b) for a, b in zip(got, base))


# -- the plane arena --------------------------------------------------------------------

KEYS = ("['blocks']['p0']['attn']['wq']", "['blocks']['p0']['mlp']['w1']", "['embed']")


@pytest.fixture(scope="module")
def leaves():
    rng = np.random.default_rng(0)
    ws = [rng.standard_normal(s).astype(np.float32) for s in ((128, 96), (128, 64), (256, 64))]
    return ([jops.pack_ecc_weights(jnp.asarray(w)) for w in ws],
            [tops.pack_ecc_weights(torch.from_numpy(w)) for w in ws])


def _assert_leaves_equal(jl, tl):
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.lo.numpy().view(np.uint32), np.asarray(a.lo))
        np.testing.assert_array_equal(b.hi.numpy().view(np.uint32), np.asarray(a.hi))
        pa = np.asarray(a.parity)
        np.testing.assert_array_equal(b.parity.numpy().view(pa.dtype), pa)


@pytest.mark.parametrize("codec", ["secded72", "ileave88"])
@pytest.mark.parametrize("env", ENVS)
def test_plane_store_under_an_environment_bit_identical(leaves, env, codec):
    jl, tl = leaves
    sv = jsc.scenario_voltage(jv.PLATFORMS["vc707"], jsc.ENVIRONMENTS[env])
    for multi in (False, True):
        kw = dict(seed=3, codecs=codec, env=env)
        jstore = jps.PlaneStore(jl, KEYS, jv.PLATFORMS["vc707"],
                                domain_key=jshapes.domain_of if multi else None, **kw)
        tstore = tps.PlaneStore(tl, KEYS, PROF, domain_key=tshapes.domain_of if multi else None,
                                **kw)
        for d in tstore.domains:
            assert dataclasses.asdict(tstore.domain_profile(d)) == dataclasses.asdict(
                jstore.domain_profile(d))
        for v in (1.0, sv, sv - 0.01):
            if multi:
                volts = {"attention": v, "mlp": v + 0.005, "embedding": 0.61}
                jf, js = jstore.set_rails(volts)
                tf, ts = tstore.set_rails(volts)
                for d in js.domains:
                    assert dataclasses.asdict(ts[d]) == dataclasses.asdict(js[d]), (v, d)
            else:
                jf, js = jstore.set_voltage(v)
                tf, ts = tstore.set_voltage(v)
                assert dataclasses.asdict(ts) == dataclasses.asdict(js), v
            _assert_leaves_equal(jf, tf)
        assert ts.total().faulty_words > 0 if multi else ts.faulty_words > 0


def test_plane_store_burst_survives_set_domain_codec(leaves):
    jl, tl = leaves
    kw = dict(seed=2, env="avionics")
    jstore = jps.PlaneStore(jl, KEYS, jv.PLATFORMS["vc707"], domain_key=jshapes.domain_of, **kw)
    tstore = tps.PlaneStore(tl, KEYS, PROF, domain_key=tshapes.domain_of, **kw)
    for s in (jstore, tstore):
        s.set_domain_codec("mlp", "dected79")
    assert all(f.burst == tsc.ENVIRONMENTS["avionics"].burst
               for f in tstore._host_fields.values())
    volts = {"attention": 0.59, "mlp": 0.585, "embedding": 0.6}
    jf, js = jstore.set_rails(volts)
    tf, ts = tstore.set_rails(volts)
    for d in js.domains:
        assert dataclasses.asdict(ts[d]) == dataclasses.asdict(js[d]), d
    _assert_leaves_equal(jf, tf)
    dev = tps.PlaneStore(tl, KEYS, PROF, mask_source="device", domain_key=tshapes.domain_of,
                         device=CPU, **kw)
    dev.set_domain_codec("mlp", "dected79")
    assert all(g.field.burst == tsc.ENVIRONMENTS["avionics"].burst for g in dev.groups)
    assert all(g.field.platform == tsc.ENVIRONMENTS["avionics"].scale_profile(PROF)
               for g in dev.groups)


def test_neutral_environment_store_equals_no_environment(leaves):
    _, tl = leaves
    a = tps.PlaneStore(tl, KEYS, PROF, seed=1)
    b = tps.PlaneStore(tl, KEYS, PROF, seed=1, env=tsc.resolve(None, drift=0.0))
    fa, sa = a.set_voltage(0.55)
    fb, sb = b.set_voltage(0.55)
    assert dataclasses.asdict(sa) == dataclasses.asdict(sb) and sa.faulty_words > 0
    assert all(torch.equal(x.lo, y.lo) and torch.equal(x.parity, y.parity)
               for x, y in zip(fa, fb))


@pytest.mark.parametrize("env", ENVS)
def test_ileave88_beats_secded72_under_every_environment(env):
    """The reference's scenario result, through the arena's inject+scrub
    counters at the environment's scenario voltage: interleaving corrects
    the adjacent doubles that SECDED only detects."""
    rng = np.random.default_rng(1)
    leaf = [tops.pack_ecc_weights(torch.from_numpy(
        rng.standard_normal((512, 1024)).astype(np.float32)))]
    sv = tsc.scenario_voltage(PROF, tsc.ENVIRONMENTS[env])
    out = {}
    for codec in ("secded72", "ileave88"):
        store = tps.PlaneStore(leaf, ("['w']",), PROF, seed=0, codecs=codec, env=env)
        out[codec] = store.set_voltage(sv)[1]
    sec, ilv = out["secded72"], out["ileave88"]
    assert sec.faulty_words > 50
    assert ilv.corrected > sec.corrected and ilv.detected < sec.detected, (sec, ilv)


# -- the KV arena ------------------------------------------------------------------------


class RecordedMasks:
    """The n-th interval draw of either arena gets the same numpy masks
    (per-bit probability 40 x the rate it was handed); each side records the
    rate (rounded to float32, as the port's draw rounds it) and the burst."""

    def __init__(self, seed):
        self.seed, self.calls, self.seen = seed, 0, []

    def draw(self, n, rate, n_check, burst):
        self.calls += 1
        self.seen.append((float(np.float32(rate)), None if burst is None
                          else dataclasses.asdict(burst)))
        rng = np.random.default_rng((self.seed, self.calls))
        bits = rng.random((64 + n_check, n), dtype=np.float32) < np.float32(rate) * 40
        w = (1 << np.arange(32, dtype=np.uint64))[:, None]
        lo = (bits[:32] * w).sum(0).astype(np.uint32)
        hi = (bits[32:64] * w).sum(0).astype(np.uint32)
        chk = (bits[64:] * w[:n_check]).sum(0)
        return lo, hi, chk.astype(np.uint8 if n_check <= 8 else np.uint32)

    def reference(self):
        def fn(key, m, rate, sigma, n_check=8, burst=None):
            return tuple(jnp.asarray(a) for a in self.draw(m, float(rate), n_check, burst))

        return lambda: fn

    def port(self):
        return lambda interval, m, rate, sigma, n_check, burst=None: self.draw(
            m, rate, n_check, burst)


def _geoms():
    jcfg = tiny_cfg()
    tcfg = tbase.ModelConfig(
        name="tiny", family="dense", n_layers=jcfg.n_layers, d_model=jcfg.d_model,
        n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads, d_ff=jcfg.d_ff, vocab=jcfg.vocab,
        head_dim=jcfg.head_dim,
    )
    return jkv.KVGeometry.from_config(jcfg, 4), tkv.KVGeometry.from_config(tcfg, 4)


def test_kv_arena_under_drift_and_bursts_bit_identical(monkeypatch):
    """20 intervals under avionics with a drift override: each side hands
    its draw the same aged rate and burst, and the planes stay equal."""
    jgeom, tgeom = _geoms()
    jm, tm = RecordedMasks(3), RecordedMasks(3)
    monkeypatch.setattr(jkv, "_device_chunk_masks_jit", jm.reference())
    env = ("avionics", 0.5)
    je, te = jsc.resolve(*env), tsc.resolve(*env)
    ja = jkv.KVPageArena(jgeom, je.scale_profile(jv.PLATFORMS["vc707"]), 4, seed=6, env=je)
    ta = tkv.KVPageArena(tgeom, te.scale_profile(PROF), 4, seed=6, env=te, device="cpu",
                         mask_fn=tm.port())
    v = tsc.scenario_voltage(PROF, te)
    for a in (ja, ta):
        a.set_voltage(v)
    for _ in range(20):
        for a in (ja, ta):
            a.tick()
        np.testing.assert_array_equal(ta.lo.numpy().view(np.uint32), np.asarray(ja.lo))
        np.testing.assert_array_equal(ta.hi.numpy().view(np.uint32), np.asarray(ja.hi))
        np.testing.assert_array_equal(ta.parity.numpy(), np.asarray(ja.parity))
    assert tm.seen == jm.seen and len(tm.seen) == 20
    rates = [r for r, _ in tm.seen]
    assert len(set(rates)) > 10  # the aging clock moved the rate
    want = [float(np.float32(te.scale_profile(PROF).fault_rate(v)
                             * tsc.aging_multiplier(0, i, te, 6))) for i in range(1, 21)]
    assert rates == want
    assert tm.seen[0][1] == dataclasses.asdict(te.burst)


def test_neutral_environment_kv_arena_equals_no_environment():
    _, tgeom = _geoms()
    arenas = [tkv.KVPageArena(tgeom, PROF, 3, seed=7, env=e, device="cpu")
              for e in (None, tsc.resolve(None, drift=0.0))]
    for a in arenas:
        a.set_voltage(0.55)
        a.tick()
    a, b = arenas
    assert torch.equal(a.lo, b.lo) and torch.equal(a.hi, b.hi) and torch.equal(a.parity, b.parity)
    assert a.lo.any()
    assert b._burst is None and b.env.drift_sigma == 0.0


def test_kv_arena_burst_stream_replays_and_is_denser():
    _, tgeom = _geoms()
    env = tsc.ENVIRONMENTS["avionics"]
    mk = lambda e, p: tkv.KVPageArena(tgeom, p, 3, seed=7, env=e, device="cpu")
    a, b, bare = mk(env, env.scale_profile(PROF)), mk(env, env.scale_profile(PROF)), \
        mk(None, PROF)
    v = tsc.scenario_voltage(PROF, env)
    for arena in (a, b, bare):
        arena.set_voltage(v)
        arena.tick()
    assert torch.equal(a.lo, b.lo) and torch.equal(a.parity, b.parity)
    assert _flips((a.lo, a.hi, a.parity)).sum() > _flips((bare.lo, bare.hi, bare.parity)).sum()


# -- the controllers' drift path --------------------------------------------------------------


def _record(r) -> dict:
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(tctl.ControllerRecord)}


def test_adaptive_drift_backoff_trajectory_equals_the_reference():
    """A locked adaptive rail re-tripped by rising flux retreats another
    step ("drift+backoff") and never resumes its walk; a fixed rail holds."""
    quiet = [0] * 8
    trip = [0, 0, 3, 0, 0, 0, 0, 0]
    stream = [quiet, trip, trip, quiet, trip, quiet, quiet, trip, trip]
    for adaptive in (False, True):
        j = jctl.UndervoltController(jv.PLATFORMS["vc707"], start_v=0.61, adaptive=adaptive)
        t = tctl.UndervoltController(PROF, start_v=0.61, adaptive=adaptive)
        for c in stream:
            assert t.update(ttel.FaultStats.from_counters(c, 1000)) == \
                j.update(jtel.FaultStats.from_counters(c, 1000))
        assert [_record(r) for r in t.history] == [_record(r) for r in j.history]
        assert ("drift+backoff" in [r.action for r in t.history]) == adaptive
    domains = ("attention", "mlp")
    j = jctl.MultiRailController(jv.PLATFORMS["vc707"], domains, start_v=0.6, adaptive=True)
    t = tctl.MultiRailController(PROF, domains, start_v=0.6, adaptive=True)
    for i in range(12):
        block = np.zeros((2, 8), np.int64)
        block[:, 2] = [int(i in (2, 5, 6)), int(i in (3, 9))]
        words = dict.fromkeys(domains, 100)
        assert t.update(ttel.FaultStats.from_counter_matrix(block, domains, words)) == \
            j.update(jtel.FaultStats.from_counter_matrix(block, domains, words))
    assert {d: [_record(r) for r in h] for d, h in t.history.items()} == {
        d: [_record(r) for r in h] for d, h in j.history.items()}


# -- the engine --------------------------------------------------------------------------------


@pytest.mark.parametrize("environment,drift", [
    ("avionics", None), ("space", 0.3), (None, 0.2), (CUSTOM, None), (None, None),
])
def test_validate_accepts_environments_and_the_profile_equals_the_reference(environment, drift):
    rel = teng.ReliabilityConfig(mode="inline", fault_model=teng.FaultModelConfig(
        environment=_env(tsc, environment), drift=drift))
    jrel = JRel(mode="inline", fault_model=JFault(environment=_env(jsc, environment),
                                                  drift=drift))
    assert rel.validate() is rel and jrel.validate() is jrel
    tp, jp = rel.environment_profile, jrel.environment_profile
    assert (tp is None) == (jp is None)
    if tp is not None:
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


def _port_cfg():
    c = tiny_cfg()
    return tbase.ModelConfig(
        name=c.name, family=c.family, n_layers=c.n_layers, d_model=c.d_model,
        n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, d_ff=c.d_ff, vocab=c.vocab,
        head_dim=c.head_dim,
    )


@pytest.fixture(scope="module")
def models():
    cfg = tiny_cfg()
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), _port_cfg(), device="cpu")
    return cfg, params, _port_cfg(), tparams


def _ecc_leaves(params, is_ecc):
    flat = jax.tree_util.tree_flatten_with_path(params, is_leaf=is_ecc)[0]
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat if is_ecc(leaf)}


@pytest.mark.parametrize("multi", [False, True], ids=["single_rail", "multi_rail"])
def test_engine_under_avionics_bit_identical(models, multi):
    """Host masks: a step at the scenario voltage (counters and faulty
    planes), then the DED-canary autotune from 0.62 V (locks and records)."""
    cfg, params, tcfg, tparams = models
    kw = dict(platform="vc707", voltage=1.0, mode="inline")
    jeng = JEngine(cfg, params, max_len=32, rel=JRel(
        **kw, rails=JRails(multi_rail=multi, start_v=0.62),
        fault_model=JFault(environment="avionics")))
    teng_ = teng.ServingEngine(tcfg, tparams, max_len=32, device="cpu", rel=teng.ReliabilityConfig(
        **kw, rails=teng.RailsConfig(multi_rail=multi, start_v=0.62),
        fault_model=teng.FaultModelConfig(environment="avionics")))
    sv = tsc.scenario_voltage(PROF, tsc.ENVIRONMENTS["avionics"])
    for e in (jeng, teng_):
        e.set_voltage(sv)
    js, ts = jeng._last_scrub, teng_._last_scrub
    if multi:
        assert {d: dataclasses.asdict(s) for d, s in ts.by_domain.items()} == {
            d: dataclasses.asdict(s) for d, s in js.by_domain.items()}
        assert ts.total().faulty_bits > 0
    else:
        assert dataclasses.asdict(ts) == dataclasses.asdict(js) and ts.faulty_bits > 0
    jl = _ecc_leaves(jeng.params, lambda x: isinstance(x, jops.EccWeight))
    tl = {k: v for k, v in tbase.flatten(teng_.params) if isinstance(v, tops.EccWeight)}
    assert sorted(tl) == sorted(jl) and tl
    _assert_leaves_equal([jl[k] for k in sorted(jl)], [tl[k] for k in sorted(tl)])
    if not multi:
        for e in (jeng, teng_):
            e.set_voltage(e.controller.voltage)
    jlock, jhist = jeng.autotune_voltage()
    tlock, thist = teng_.autotune_voltage()
    assert tlock == jlock
    if multi:
        assert {d: [_record(r) for r in h] for d, h in thist.items()} == {
            d: [_record(r) for r in h] for d, h in jhist.items()}
    else:
        assert [_record(r) for r in thist] == [_record(r) for r in jhist]
    assert dataclasses.asdict(teng_.stats) == dataclasses.asdict(jeng.stats)


@pytest.mark.parametrize("rel_kw", [
    dict(mode="inline", fault_model=dict(batched=False)), dict(mode="domain"),
], ids=["per_leaf", "domain"])
def test_per_leaf_and_domain_mode_ignore_the_environment(models, rel_kw):
    """As in the reference, only the batched arena and the KV cache see an
    environment: these engines' faulty weights equal the env=None ones'."""
    _, _, tcfg, tparams = models
    engines = []
    for env in (None, "space"):
        fm = teng.FaultModelConfig(**rel_kw.get("fault_model", {}), environment=env)
        rel = teng.ReliabilityConfig(platform="vc707", voltage=0.56, mode=rel_kw["mode"],
                                     fault_model=fm)
        engines.append(teng.ServingEngine(tcfg, tparams, rel=rel, max_len=32, device="cpu"))
    a, b = engines
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats) and a.stats.faulty_bits > 0
    for (ka, x), (kb, y) in zip(tbase.flatten(a.params), tbase.flatten(b.params)):
        assert ka == kb
        for f in ("lo", "hi", "parity") if isinstance(x, tops.EccWeight) else (None,):
            xa, ya = (getattr(x, f), getattr(y, f)) if f else (x, y)
            if isinstance(xa, torch.Tensor):
                assert torch.equal(xa, ya), (ka, f)


PROMPTS = np.random.default_rng(0).integers(0, 128, (4, 8)).astype(np.int32)
STREAM = [(PROMPTS[i][:4], 4) for i in range(4)]


@pytest.mark.parametrize("multi", [False, True], ids=["single_rail", "multi_rail"])
def test_paged_serve_under_avionics_matches_the_reference(models, monkeypatch, multi):
    """Shared numpy masks: the aged, env-scaled interval rates and the burst
    each side hands its draw are equal, and so are tokens, KV counters and
    kv voltages (multi-rail: the store's scaled kv profile, walk_kv)."""
    cfg, params, tcfg, tparams = models
    jm, tm = RecordedMasks(9), RecordedMasks(9)
    monkeypatch.setattr(jkv, "_device_chunk_masks_jit", jm.reference())
    monkeypatch.setattr(tfs, "interval_masks",
                        lambda seed, interval, m, rate, sigma, n_check=8, device=None,
                        burst=None: tm.draw(m, rate, n_check, burst))
    kw = dict(platform="vc707", voltage=1.0, mode="inline")
    fault = dict(environment="avionics", drift=0.4)
    rails = dict(multi_rail=multi, start_v=0.6)
    jeng = JEngine(cfg, params, max_len=32, rel=JRel(
        **kw, rails=JRails(**rails), fault_model=JFault(**fault)))
    teng_ = teng.ServingEngine(tcfg, tparams, max_len=32, device="cpu", rel=teng.ReliabilityConfig(
        **kw, rails=teng.RailsConfig(**rails), fault_model=teng.FaultModelConfig(**fault)))
    sv = tsc.scenario_voltage(PROF, tsc.ENVIRONMENTS["avionics"])
    serve = dict(n_lanes=2, scrub_interval=2)
    serve.update(walk_kv=True) if multi else serve.update(kv_voltage=sv)
    j = jeng.serve(STREAM, **serve)
    t = teng_.serve(STREAM, **serve)
    assert sorted(t.outputs) == sorted(j.outputs)
    for rid in j.outputs:
        np.testing.assert_array_equal(t.outputs[rid], np.asarray(j.outputs[rid]))
    assert dataclasses.asdict(t.kv_stats) == dataclasses.asdict(j.kv_stats)
    assert t.kv_voltages == [float(v) for v in j.kv_voltages]
    assert tm.seen == jm.seen and tm.seen
    assert tm.seen[0][1] == dataclasses.asdict(tsc.ENVIRONMENTS["avionics"].burst)
    assert t.kv_stats.corrected > 0
