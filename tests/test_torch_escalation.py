"""Port parity of codec escalation: the controllers' ladder, the KV arena's
re-protection (``change_codec``) and its refusal on shared pages, the prefix
trie's forced eviction, an escalating multi-rail autotune, and serves whose
`kv` rail escalates mid-stream, one of them through refuse-and-copy.

The engine runs hand both packages the same numpy KV interval masks
(``test_torch_serve.Masks``, whose draw follows the codec's check width) and
the same host weight masks, so every counter, record and trace event must be
equal, the flight recorder's JSONL byte for byte. The autotune-after-serve
case holds the loop that stops once the weight arena's rails are locked,
whatever a late-bound `kv` rail does.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_cfg
from repro.core import controller as jctl
from repro.core import kvpages as jkv
from repro.core.telemetry import DomainFaultStats as JDomainStats
from repro.core.telemetry import FaultStats as JStats
from repro.core.voltage import PLATFORMS as JPLATFORMS
from repro.models import lm as jlm
from repro.obs import TraceRecorder as JRecorder
from repro.serving.engine import ProtectionConfig as JProt
from repro.serving.engine import RailsConfig as JRails
from repro.serving.engine import ReliabilityConfig as JRel
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import codes as tcodes
from repro_torch.core import controller as tctl
from repro_torch.core import kvpages as tkv
from repro_torch.core.telemetry import DomainFaultStats, FaultStats
from repro_torch.core.voltage import PLATFORMS
from repro_torch.models import base as tbase
from repro_torch.obs import KernelProfiler, TraceRecorder
from repro_torch.obs import profile as obs_profile
from repro_torch.serving import engine as teng
from test_torch_serve import MIXED, PT, SHARED, Masks, _port_cfg

MAX_LEN = 32
CODECS = ("parity65", "secded72", "ileave88", "dected79")
LADDERS = {
    "two": ("secded72", "dected79"),
    "three": ("secded72", "ileave88", "dected79"),
    "from_parity": ("parity65", "secded72", "dected79"),
}
# a flip pattern in one `hi` word that each code detects and cannot correct
# (ileave88: two flips in one subcode, data bits 32 and 36)
DED_FLIP = {"parity65": 0b1, "secded72": 0b11, "ileave88": 0b10001, "dected79": 0b111}


def _record(r) -> dict:
    """A controller record by the port's fields (the reference's also carry
    mesh-shard and accuracy-canary fields)."""
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(tctl.ControllerRecord)}


def _stats(s) -> dict:
    return dataclasses.asdict(s)


# ---------------------------------------------------------------------------
# the controllers
# ---------------------------------------------------------------------------
def _stats_sequence(seed: int, n: int = 24) -> list:
    """(words, corrected, detected, silent) per interval: a fixed order of
    kinds (a DED burst above 1% first, then a silent-only interval, a DED
    trickle below 1%, more bursts), then random kinds; random sizes."""
    g = np.random.default_rng(seed)
    head = ["clean", "ded_high", "clean", "silent", "ded_low", "ded_high", "clean", "ded_high"]
    kinds = head + list(g.choice(["clean", "ded_low", "ded_high", "silent"], n - len(head)))
    out = []
    for kind in kinds:
        words = int(g.integers(500, 2000))
        corrected = int(g.integers(0, 20))
        detected = {"clean": 0, "silent": 0, "ded_low": int(g.integers(1, 4)),
                    "ded_high": int(g.integers(30, 80))}[str(kind)]
        silent = int(g.integers(1, 3)) if kind == "silent" else 0
        out.append((words, corrected, detected, silent))
    return out


def _pair(policy_kw, **kw):
    """The reference's and the port's controllers, each with a recorder."""
    jr, tr = JRecorder(), TraceRecorder()
    j = jctl.UndervoltController(
        JPLATFORMS["vc707"], escalation=jctl.EscalationPolicy(**policy_kw), domain="kv", **kw)
    t = tctl.UndervoltController(
        PLATFORMS["vc707"], escalation=tctl.EscalationPolicy(**policy_kw), domain="kv", **kw)
    j.bind_recorder(jr)
    t.bind_recorder(tr)
    return (j, jr), (t, tr)


@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("ded_rate", [0.0, 0.01])
@pytest.mark.parametrize("paranoid", [False, True])
def test_controller_matches_reference(ladder, ded_rate, paranoid):
    (j, jr), (t, tr) = _pair(dict(ladder=LADDERS[ladder], ded_rate=ded_rate),
                             start_v=0.6, paranoid=paranoid)
    assert t.codec == j.codec == LADDERS[ladder][0]
    for i, (w, c, d, s) in enumerate(_stats_sequence(len(ladder) + int(ded_rate * 100) + paranoid)):
        vj = j.update(JStats(words=w, corrected=c, detected=d, silent=s))
        vt = t.update(FaultStats(words=w, corrected=c, detected=d, silent=s))
        assert vt == vj, i
        assert t.pop_codec_change() == j.pop_codec_change(), i
        assert (t.codec, t.locked) == (j.codec, j.locked), i
    assert [_record(r) for r in t.history] == [_record(r) for r in j.history]
    assert any(r.action == "escalate" for r in t.history)
    assert tr.to_jsonl() == jr.to_jsonl()
    assert len(tr.of_kind("codec_escalate")) == sum(r.action == "escalate" for r in t.history)


@pytest.mark.parametrize("detected,ded_rate,action", [
    (5, 0.01, "trip+backoff"),  # 0.5% <= 1%: back off
    (50, 0.01, "escalate"),  # 5% > 1%
    (1, 0.0, "escalate"),
])
def test_ded_rate_threshold_matches_reference(detected, ded_rate, action):
    (j, _), (t, _) = _pair(dict(ladder=LADDERS["two"], ded_rate=ded_rate), start_v=0.57)
    j.update(JStats(words=1000, detected=detected))
    t.update(FaultStats(words=1000, detected=detected))
    assert t.history[-1].action == j.history[-1].action == action
    assert (t.codec, t.locked, t.voltage) == (j.codec, j.locked, j.voltage)


def test_paranoid_silent_trip_never_escalates():
    (j, jr), (t, tr) = _pair(dict(ladder=LADDERS["two"]), start_v=0.57, paranoid=True)
    j.update(JStats(words=1000, silent=2))
    t.update(FaultStats(words=1000, silent=2))
    assert t.locked and t.codec == "secded72" and t.pop_codec_change() is None
    assert [_record(r) for r in t.history] == [_record(r) for r in j.history]
    assert tr.to_jsonl() == jr.to_jsonl()


def test_pop_codec_changes_matches_reference():
    """A multi-rail controller's changes by domain; a late `kv` rail takes
    the ladder."""
    policy = dict(ladder=LADDERS["three"])
    j = jctl.MultiRailController(JPLATFORMS["vc707"], ("attention", "mlp"), start_v=0.58,
                                 escalation=jctl.EscalationPolicy(**policy))
    t = tctl.MultiRailController(PLATFORMS["vc707"], ("attention", "mlp"), start_v=0.58,
                                 escalation=tctl.EscalationPolicy(**policy))
    assert t.add_rail("kv").escalation == tctl.EscalationPolicy(**policy)
    j.add_rail("kv")
    g = np.random.default_rng(7)
    seen = []
    for _ in range(12):
        rows = {d: (1000, int(g.integers(0, 9)), int(g.integers(0, 3)) * int(g.random() < 0.4))
                for d in ("attention", "mlp", "kv")}
        j.update(JDomainStats({d: JStats(words=w, corrected=c, detected=x)
                               for d, (w, c, x) in rows.items()}))
        t.update(DomainFaultStats({d: FaultStats(words=w, corrected=c, detected=x)
                                   for d, (w, c, x) in rows.items()}))
        changes = t.pop_codec_changes()
        assert changes == j.pop_codec_changes()
        seen.append(changes)
        assert t.codecs == j.codecs and t.voltages == j.voltages
    assert any(seen) and t.pop_codec_changes() == {}


# ---------------------------------------------------------------------------
# the KV arena and the prefix trie
# ---------------------------------------------------------------------------
GEOM = dict(attn_positions=(0,), n_groups=1, n_kv_heads=2, head_dim=8, page_tokens=4)
N_PAGES = 3


def _arenas(codec):
    """Both packages' arenas under ``codec`` with the same committed payload
    on every page."""
    jg, tg = jkv.KVGeometry(**GEOM), tkv.KVGeometry(**GEOM)
    ja = jkv.KVPageArena(jg, JPLATFORMS["vc707"], N_PAGES, codec=codec)
    ta = tkv.KVPageArena(tg, PLATFORMS["vc707"], N_PAGES, codec=codec, device="cpu")
    g = np.random.default_rng(CODECS.index(codec))
    n_tok = GEOM["page_tokens"] * N_PAGES
    payload = g.standard_normal((n_tok, tg.token_f32)).astype(np.float32)
    pages = np.repeat(np.arange(N_PAGES), GEOM["page_tokens"])
    slots = np.tile(np.arange(GEOM["page_tokens"]), N_PAGES)
    ja.commit_tokens(jnp.asarray(payload), pages, slots)
    ta.commit_tokens(torch.from_numpy(payload), pages, slots)
    return ja, ta, payload


def _check_plane(a):
    p = np.asarray(a.parity) if isinstance(a.parity, jax.Array) else a.parity.numpy()
    return p.view(np.uint32) if p.dtype == np.int32 else p


def _assert_planes_equal(ja, ta):
    np.testing.assert_array_equal(ta.lo.numpy().view(np.uint32), np.asarray(ja.lo))
    np.testing.assert_array_equal(ta.hi.numpy().view(np.uint32), np.asarray(ja.hi))
    want = np.asarray(ja.parity)
    assert ta.parity.dtype == tcodes.get(ta.codec_name).check_torch_dtype
    assert _check_plane(ta).dtype == want.dtype
    np.testing.assert_array_equal(_check_plane(ta), want)


@pytest.mark.parametrize("src,dst", list(itertools.permutations(CODECS, 2)))
def test_change_codec_matches_reference(src, dst):
    """Every ordered codec pair: a planted uncorrectable word on a shared
    page refuses the change in both packages (same pages, same code, planes
    untouched); without that page among the shared ones, both re-encode to
    the same check plane, and the contents read back."""
    ja, ta, payload = _arenas(src)
    w = ja.geom.words_per_page
    word = w + 3  # page 1
    flip = np.uint32(DED_FLIP[src])
    ja.hi = ja.hi.at[word].set(ja.hi[word] ^ flip)
    ta.hi[word] ^= int(flip)
    with pytest.raises(jkv.SharedPageDEDError) as jerr:
        ja.change_codec(dst, shared_pages=[0, 1])
    with pytest.raises(tkv.SharedPageDEDError) as terr:
        ta.change_codec(dst, shared_pages=[0, 1])
    assert terr.value.pages == jerr.value.pages == (1,)
    assert terr.value.codec == jerr.value.codec == dst
    assert ta.codec_name == ja.codec_name == src
    _assert_planes_equal(ja, ta)
    assert _stats(ta.stats) == _stats(ja.stats) and ta.stats.detected == 1
    _, cnt = ta.scrub_pages([1])  # the DED stays latched, not sealed
    assert cnt[0, 2] == 1
    ja.scrub_pages(np.array([1], np.int32))
    # page 1 no longer shared: both re-encode
    ja.change_codec(dst, shared_pages=[0])
    ta.change_codec(dst, shared_pages=[0])
    assert ta.codec_name == ja.codec_name == dst
    _assert_planes_equal(ja, ta)
    got, cnt = ta.scrub_pages([0, 2])
    np.testing.assert_array_equal(
        got.numpy().reshape(2, GEOM["page_tokens"], -1),
        payload.reshape(N_PAGES, GEOM["page_tokens"], -1)[[0, 2]])
    assert cnt[:, 1].sum() == 0 and cnt[:, 2].sum() == 0


def test_change_codec_to_the_same_code_is_a_no_op():
    _, ta, _ = _arenas("secded72")
    plane = ta.parity
    ta.change_codec("secded72", shared_pages=[0, 1, 2])
    assert ta.parity is plane and ta.stats.words == 0


def test_evict_pages_matches_reference():
    """A page and every descendant chunk leave the trie; readers keep their
    references; the recorder's ``trie_evict`` says ``forced``."""
    tries = {}
    for pkg, mod, rec in (("ref", jkv, JRecorder()), ("port", tkv, TraceRecorder())):
        alloc = mod.PageAllocator(12)
        trie = mod.PrefixTrie(alloc, 2, recorder=rec)
        seqs = [[1, 2, 3, 4, 5, 6, 7], [1, 2, 3, 4, 9, 9, 9], [1, 2, 8, 8, 8], [5, 5, 5]]
        for rid, seq in enumerate(seqs):
            hit = trie.lookup(seq)
            pages = list(hit)
            for p in hit:
                alloc.share(p, rid)
            while len(pages) < len(seq) // 2:
                pages.append(alloc.alloc(rid))
            trie.insert(seq, pages)
        dropped = trie.evict_pages([1, 99])  # page 1: the chunk (3, 4), two children below
        tries[pkg] = (dropped, trie.pages(), alloc.free_pages, [alloc.refcount(p) for p in
                                                                 range(12)], rec.to_jsonl())
    assert tries["port"] == tries["ref"]
    assert len(tries["port"][0]) == 3 and '"reason":"forced"' in tries["port"][4]


# ---------------------------------------------------------------------------
# the engine: escalating autotune and serves, against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    cfg = tiny_cfg()
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), _port_cfg(cfg), device="cpu"
    )
    return cfg, params, _port_cfg(cfg), tparams


RUNS = {
    # autotune from 0.62 V with a three-rung ladder, then a walk_kv serve whose
    # kv rail escalates mid-stream
    "autotune_walk_kv": dict(
        seed=1, start_v=0.62, ladder=LADDERS["three"], autotune=20, scale=40.0, mask_seed=3,
        reqs=MIXED[:4], serve=dict(n_lanes=2, walk_kv=True, scrub_interval=1)),
    # a shared-prefix serve whose escalation meets a latched DED on a shared
    # page: the trie lets go of it, its readers are preempted, then the
    # arena is re-protected
    "refuse_and_copy": dict(
        seed=0, start_v=0.57, ladder=LADDERS["two"], autotune=0, scale=40.0, mask_seed=1,
        reqs=SHARED, serve=dict(n_lanes=2, walk_kv=True, scrub_interval=1, share_prefix=True)),
    # no ladder: a walk_kv serve leaves the kv rail unlocked; the autotune
    # after it stops once the weight rails are locked
    "autotune_after_walk_kv": dict(
        seed=1, start_v=0.62, ladder=None, autotune=12, autotune_after=True, scale=1.0,
        mask_seed=2, reqs=[(MIXED[i][0], 8) for i in range(4)],
        serve=dict(n_lanes=4, walk_kv=True, scrub_interval=1)),
}


def _engine_run(models, case):
    cfg, params, tcfg, tparams = models
    spec = RUNS[case]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        Masks(seed=spec["mask_seed"], scale=spec["scale"]).install(mp)
        for pkg in ("ref", "port"):
            if pkg == "ref":
                rec = JRecorder()
                rel = JRel(platform="vc707", voltage=1.0, mode="inline", seed=spec["seed"],
                           rails=JRails(multi_rail=True, start_v=spec["start_v"]),
                           protection=JProt(escalation=spec["ladder"]))
                eng = JEngine(cfg, params, rel=rel, max_len=MAX_LEN, recorder=rec)
            else:
                rec = TraceRecorder()
                rel = teng.ReliabilityConfig(
                    platform="vc707", voltage=1.0, mode="inline", seed=spec["seed"],
                    rails=teng.RailsConfig(multi_rail=True, start_v=spec["start_v"]),
                    protection=teng.ProtectionConfig(escalation=spec["ladder"]))
                eng = teng.ServingEngine(tcfg, tparams, rel=rel, max_len=MAX_LEN,
                                         device="cpu", recorder=rec)
            res = {}

            def autotune():
                volts, hist = eng.autotune_voltage(max_rounds=spec["autotune"])
                res["autotune"] = {
                    "volts": dict(volts),
                    "history": {d: [_record(r) for r in h] for d, h in hist.items()},
                    "codecs": dict(eng.controller.codecs),
                    "store_codecs": {d: eng._store.codec_of(d) for d in eng._store.domains},
                    "power": eng.power_report(),
                }

            if spec["autotune"] and not spec.get("autotune_after"):
                autotune()
            res["report"] = eng.serve(spec["reqs"], page_tokens=PT, **spec["serve"])
            kv = eng.controller.rails["kv"]
            res["kv_rail"] = ([_record(r) for r in kv.history], kv.codec, kv.locked)
            if spec.get("autotune_after"):
                autotune()
            res["power"] = eng.power_report()
            res["stats"] = _stats(eng.stats)
            res["jsonl"] = rec.to_jsonl()
            res["events"] = rec.events
            out[pkg] = res
    return out


@pytest.fixture(scope="module")
def runs(models):
    """Each case's run, made when a test first asks for it."""

    class Runs(dict):
        def __missing__(self, case):
            self[case] = _engine_run(models, case)
            return self[case]

    return Runs()


def _kinds(events) -> dict:
    out = {}
    for e in events:
        out[e["kind"]] = out.get(e["kind"], 0) + 1
    return out


@pytest.mark.parametrize("case", sorted(RUNS))
def test_serve_matches_reference(runs, case):
    j, t = runs[case]["ref"]["report"], runs[case]["port"]["report"]
    assert sorted(t.outputs) == sorted(j.outputs)
    for rid, (_, n) in enumerate(RUNS[case]["reqs"]):
        np.testing.assert_array_equal(t.outputs[rid], np.asarray(j.outputs[rid]))
        assert len(t.outputs[rid]) == n
    for f in ("steps", "preemptions", "pages_free_at_end", "prefix_hit_tokens"):
        assert getattr(t, f) == getattr(j, f), f
    assert _stats(t.kv_stats) == _stats(j.kv_stats)
    assert {r: _stats(s) for r, s in t.request_stats.items()} == {
        r: _stats(s) for r, s in j.request_stats.items()}
    assert t.kv_voltages == [float(v) for v in j.kv_voltages]
    assert t.arena.codec_name == j.arena.codec_name
    assert runs[case]["port"]["kv_rail"] == runs[case]["ref"]["kv_rail"]
    assert runs[case]["port"]["power"] == runs[case]["ref"]["power"]
    assert runs[case]["port"]["stats"] == runs[case]["ref"]["stats"]
    if RUNS[case]["ladder"]:
        # the kv rail escalated mid-stream and the arena followed it
        assert t.arena.codec_name == runs[case]["port"]["kv_rail"][1] != "secded72"
        assert t.arena.parity.dtype == torch.int32
        assert runs[case]["port"]["power"]["codecs"]["kv"] == t.arena.codec_name


@pytest.mark.parametrize("case", sorted(RUNS))
def test_trace_jsonl_equals_reference(runs, case):
    assert runs[case]["port"]["jsonl"] == runs[case]["ref"]["jsonl"]
    kinds = _kinds(runs[case]["port"]["events"])
    if case == "refuse_and_copy":
        assert kinds["shared_ded_recovery"] == 1 and runs[case]["port"]["report"].preemptions >= 1
        assert any(e["kind"] == "trie_evict" and e["reason"] == "forced"
                   for e in runs[case]["port"]["events"])
    if RUNS[case]["ladder"]:
        assert kinds["kv_codec_change"] >= 1 and kinds["codec_escalate"] >= 1


def test_escalating_autotune_matches_reference(runs):
    j, t = runs["autotune_walk_kv"]["ref"]["autotune"], runs["autotune_walk_kv"]["port"]["autotune"]
    assert t == j
    # every arena rail escalated at an unchanged voltage, and its domain
    # is stored under the code its rail reached
    for d, hist in t["history"].items():
        k = next(i for i, r in enumerate(hist) if r["action"] == "escalate")
        assert hist[k]["voltage"] == hist[k - 1]["voltage"]
    assert t["store_codecs"] == {d: t["codecs"][d] for d in t["store_codecs"]}
    assert t["power"]["check_bits"] == {
        d: tcodes.get(c).n_check for d, c in t["power"]["codecs"].items()}
    assert len(set(t["codecs"].values())) > 1  # the rails reached different rungs


def test_autotune_after_walk_kv_stops_on_the_arena_rails(runs):
    """The kv rail left unlocked by the serve does not hold the autotune:
    no ``hold`` record is appended to the locked weight rails."""
    r = runs["autotune_after_walk_kv"]
    assert not r["port"]["kv_rail"][2]  # the serve left the kv rail unlocked
    j, t = r["ref"]["autotune"], r["port"]["autotune"]
    assert t == j
    for d in ("attention", "mlp", "embedding"):
        assert t["history"][d][-1]["action"] in ("trip+backoff", "floor")
        assert all(rec["action"] != "hold" for rec in t["history"][d])


# ---------------------------------------------------------------------------
# scrub_overlap: equal results, and the path None takes under a ladder
# ---------------------------------------------------------------------------
def test_scrub_overlap_modes_and_demotion(models, monkeypatch):
    """True (deferred harvest), False (serialized) and None give equal
    tokens, counters, kv voltages and codecs; the deferred harvest alone
    leaves the ``serve.scrub_overlap_frac`` gauge under the profiler, which
    shows the path: None under a ladder runs serialized."""
    _, _, tcfg, tparams = models
    rel = teng.ReliabilityConfig(
        platform="vc707", voltage=1.0, mode="inline",
        rails=teng.RailsConfig(multi_rail=True, start_v=0.57),
        protection=teng.ProtectionConfig(escalation=LADDERS["two"]))
    got = {}
    for mode in (True, False, None):
        Masks(seed=3, scale=40.0).install(monkeypatch)
        eng = teng.ServingEngine(tcfg, tparams, rel=rel, max_len=MAX_LEN, device="cpu")
        prof = obs_profile.enable(KernelProfiler())
        try:
            rep = eng.serve(MIXED, page_tokens=PT, n_lanes=2, walk_kv=True, scrub_interval=2,
                            scrub_overlap=mode)
        finally:
            obs_profile.disable()
        got[mode] = ({r: v.tolist() for r, v in rep.outputs.items()}, _stats(rep.kv_stats),
                     rep.kv_voltages, rep.arena.codec_name, rep.steps)
        deferred = [g["name"] for g in prof.gauge_rows()] == ["serve.scrub_overlap_frac"]
        assert deferred == (mode is True), mode
    assert got[True] == got[False] == got[None]
    assert got[None][3] == "dected79"
