"""The port's flight recorder (``repro_torch.obs``): the event schema, the
metrics registry, the step-clock traces and their exports, the dispatch
profiler, and the recorder threaded through serve, the scheduler, the
prefix trie and the rail controllers.

The parity runs hold the port's trace against the reference's event for
event and byte for byte: a multi-rail engine's autotune walk followed by a
``walk_kv`` shared-prefix serve that preempts, and a speculative serve at an
undervolted kv rail. Both packages get the same numpy KV interval masks
(``test_torch_serve.Masks``) and host weight masks, so every counter in the
trace is the same; the JSONL bytes, the metrics, the markdown summary, the
Chrome trace and the report CLI's output must be equal.
"""

import json
import types

import numpy as np
import pytest

import jax

from conftest import tiny_cfg
from repro.models import lm as jlm
from repro.obs import ENVELOPE_FIELDS as J_ENVELOPE
from repro.obs import EVENT_KINDS as J_EVENT_KINDS
from repro.obs import TraceRecorder as JRecorder
from repro.obs import report as jreport
from repro.serving.engine import RailsConfig as JRails
from repro.serving.engine import ReliabilityConfig as JRel
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.core.telemetry import DomainFaultStats, FaultStats
from repro_torch.models import base as tbase
from repro_torch.obs import (
    ENVELOPE_FIELDS,
    EVENT_KINDS,
    EventSchemaError,
    KernelProfiler,
    MetricsRegistry,
    TraceRecorder,
    read_jsonl,
    summary_markdown,
    to_chrome_trace,
    to_jsonl,
    validate_events,
)
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import report as treport
from repro_torch.serving import engine as teng
from test_torch_serve import Masks, _port_cfg

MAX_LEN = 32
PT = 4  # tokens per page
RNG = np.random.default_rng(0)
PROMPTS = RNG.integers(0, 128, (6, 12)).astype(np.int32)
PREFIX = RNG.integers(0, 128, 2 * PT).astype(np.int32)
MIXED = [(PROMPTS[i][: 3 + i], 3 + (2 * i) % 7) for i in range(6)]
SHARED = [(np.concatenate([PREFIX, PROMPTS[i][: 1 + i % 3]]), 4 + i % 3) for i in range(6)]


@pytest.fixture(scope="module")
def models():
    cfg = tiny_cfg()
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), _port_cfg(cfg), device="cpu"
    )
    dcfg = tiny_cfg(n_layers=1)
    dparams = jlm.init_params(dcfg, jax.random.PRNGKey(5))
    tdparams = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, dparams), _port_cfg(dcfg), device="cpu"
    )
    return cfg, params, _port_cfg(cfg), tparams, (dcfg, dparams, _port_cfg(dcfg), tdparams)


# ---------------------------------------------------------------------------
# events + recorder core
# ---------------------------------------------------------------------------
def test_schema_is_the_reference_schema():
    assert ENVELOPE_FIELDS == J_ENVELOPE
    assert EVENT_KINDS == J_EVENT_KINDS


def test_emit_validates_and_orders():
    rec = TraceRecorder()
    rec.emit("serve_begin", n_requests=2, n_lanes=2, scrub_interval=4)
    rec.advance(3)
    ev = rec.emit("gauge", name="queue_depth", value=1)
    assert ev["seq"] == 1 and ev["step"] == 3
    assert validate_events(rec.events) == 2


def test_emit_rejects_unknown_kind_and_missing_payload():
    rec = TraceRecorder()
    with pytest.raises(EventSchemaError):
        rec.emit("not_a_kind")
    with pytest.raises(EventSchemaError):
        rec.emit("gauge", name="only_half")  # missing `value`
    loose = TraceRecorder(strict=False)  # defers validation to export time
    loose.emit("gauge", name="only_half")
    with pytest.raises(EventSchemaError):
        validate_events(loose.events)


def test_validate_events_rejects_seq_disorder():
    rec = TraceRecorder()
    rec.emit("canary_probe", divergence=0.0)
    rec.emit("canary_probe", divergence=0.1)
    with pytest.raises(EventSchemaError):
        validate_events([rec.events[1], rec.events[0]])


def test_extra_payload_fields_allowed():
    rec = TraceRecorder()
    rec.emit("trie_evict", pages=3, reason="lru")
    assert rec.events[0]["reason"] == "lru"
    assert validate_events(rec.events) == 1


def test_every_kind_has_envelope_free_payload():
    for kind, fields in EVENT_KINDS.items():
        assert not set(fields) & set(ENVELOPE_FIELDS), kind


def test_to_jsonl_accepts_events_or_recorder():
    rec = TraceRecorder()
    rec.emit("canary_probe", divergence=0.5)
    s1, s2 = to_jsonl(rec), to_jsonl(rec.events)
    assert s1 == s2 and s1.endswith("\n")
    assert json.loads(s1.splitlines()[0])["kind"] == "canary_probe"


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def test_metrics_counter_gauge_histogram():
    m = MetricsRegistry()
    m.counter("hits").inc()
    m.counter("hits").inc(4)
    m.gauge("depth", shard=0).set(3)
    m.gauge("depth", shard=0).set(1)
    h = m.histogram("lat", buckets=(1, 2, 4))
    for v in (1, 3, 9):
        h.observe(v)
    snap = m.to_dict()
    assert snap["hits"]["value"] == 5
    assert snap["depth{shard=0}"]["value"] == 1
    assert snap["depth{shard=0}"]["max"] == 3
    assert snap["lat"]["count"] == 3
    assert snap["lat"]["counts"][-1] == 1  # 9 overflows the last bucket


def test_metrics_label_identity_and_type_guard():
    m = MetricsRegistry()
    assert m.counter("x", a=1, b=2) is m.counter("x", b=2, a=1)
    assert m.counter("x", a=1, b=2) is not m.counter("x", a=1)
    with pytest.raises(AssertionError):
        m.gauge("x", a=1, b=2)  # same name and labels, another type


def test_observe_fault_stats_folds_containers():
    m = MetricsRegistry()
    st = FaultStats(words=10, corrected=3, detected=1, shard=2)
    dom = DomainFaultStats({"mlp": st, "kv": FaultStats(words=5, silent=2)})
    m.observe_fault_stats("scrub", dom)
    assert m.get("scrub.corrected", domain="mlp", shard=2).value == 3
    assert m.get("scrub.silent", domain="kv").value == 2
    # a per-shard container (the reference's ShardFaultStats shape)
    sh = types.SimpleNamespace(by_shard=[DomainFaultStats({"kv": st}, shard=2)])
    m2 = MetricsRegistry()
    m2.observe_fault_stats("scrub", sh)
    assert m2.get("scrub.words", domain="kv", shard=2).value == 10


def test_faultstats_to_dict_and_coverage_row():
    st = FaultStats(
        words=100, corrected=3, detected=2, silent=1,
        words_1bit=3, words_2bit=2, words_multi=1, faulty_bits=10,
    )
    d = st.to_dict()
    assert d["words"] == 100 and d["faulty_words"] == 6
    assert "shard" not in d
    assert FaultStats(words=1, shard=3).to_dict()["shard"] == 3
    row = st.coverage_row()
    assert row["coverage_correctable"] == 3 / 6
    assert row["coverage_silent"] == 1 / 6


# ---------------------------------------------------------------------------
# profiler (time kept out of the event log)
# ---------------------------------------------------------------------------
def test_profiler_records_only_when_enabled():
    calls = []
    fn = lambda x: (calls.append(x), x * 2)[1]
    assert obs_profile.active() is None
    assert obs_profile.call("noop", fn, 3) == 6  # off: passthrough
    prof = obs_profile.enable(KernelProfiler())
    try:
        assert obs_profile.call("timed", fn, 4) == 8
    finally:
        obs_profile.disable()
    assert obs_profile.active() is None
    rows = prof.to_rows()
    assert [r["name"] for r in rows] == ["timed"]
    assert rows[0]["calls"] == 1 and rows[0]["total_ms"] >= 0.0
    assert rows[0]["backend"] == "plain"  # no tensor on the card
    assert calls == [3, 4]


# ---------------------------------------------------------------------------
# the port's serve traces: determinism, recorder off = on, exports
# ---------------------------------------------------------------------------
def _serve(models, recorder=None, start_v=None):
    _, _, tcfg, tparams, _ = models
    eng = teng.ServingEngine(
        tcfg, tparams,
        rel=teng.ReliabilityConfig(
            mode="inline", voltage=0.58, seed=1,
            rails=teng.RailsConfig(multi_rail=True, start_v=start_v),
        ),
        max_len=64, device="cpu", recorder=recorder,
    )
    return eng.serve(MIXED[:4], n_lanes=2, scrub_interval=2, walk_kv=True, kv_voltage=0.57)


@pytest.fixture(scope="module")
def port_trace(models):
    rec = TraceRecorder()
    rep = _serve(models, recorder=rec)
    return rec, rep


def test_trace_jsonl_byte_identical_across_runs(models, port_trace, tmp_path):
    rec0, _ = port_trace
    rec1 = TraceRecorder()
    _serve(models, recorder=rec1)
    paths = [tmp_path / "run0.jsonl", tmp_path / "run1.jsonl"]
    rec0.to_jsonl(paths[0])
    rec1.to_jsonl(paths[1])
    assert paths[0].read_bytes() == paths[1].read_bytes()
    evs = read_jsonl(paths[0])
    assert validate_events(evs) == len(evs) > 0


def test_recorder_off_bit_identical(models, port_trace):
    """Recorder absent or attached: the same tokens, counters, kv rail walk
    and steps."""
    rec, r_on = port_trace
    r_off = _serve(models)
    assert sorted(r_off.outputs) == sorted(r_on.outputs)
    for rid in r_off.outputs:
        np.testing.assert_array_equal(r_off.outputs[rid], r_on.outputs[rid], err_msg=str(rid))
    assert r_off.kv_stats.counters().tolist() == r_on.kv_stats.counters().tolist()
    assert r_off.kv_voltages == r_on.kv_voltages
    assert r_off.steps == r_on.steps
    assert len(rec.events) > 0


def test_trace_covers_serve_lifecycle(port_trace):
    rec, rep = port_trace
    kinds = {e["kind"] for e in rec.events}
    assert {"serve_begin", "admit", "retire", "kv_scrub", "gauge", "rail_step",
            "serve_end"} <= kinds
    admits, retires = rec.of_kind("admit"), rec.of_kind("retire")
    assert len(admits) == len(retires) == len(rep.outputs) == 4
    for ev in retires:
        assert ev["latency_steps"] >= ev["tokens"] - 1 >= 0
    end = rec.of_kind("serve_end")[-1]
    assert end["steps"] == rep.steps
    assert end["finished"] == len(rep.outputs)
    assert len(rec.of_kind("kv_scrub")) == len(rep.kv_voltages)
    for ev in rec.of_kind("rail_step"):  # the kv rail's steps join their counters
        assert ev["domain"] == "kv"
        assert ev["words"] >= 0 and ev["corrected"] >= 0
    assert rec.metrics.get("serve.admissions").value == 4
    assert rec.metrics.get("serve.steps", shard=0).value == rep.steps


def test_chrome_trace_layout(port_trace, tmp_path):
    rec, rep = port_trace
    path = tmp_path / "trace.json"
    ct = to_chrome_trace(rec, path)
    assert json.loads(path.read_text()) == ct
    evs = ct["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X"]  # one span per request lifetime
    assert len(spans) == len(rep.outputs)
    assert all(e["dur"] >= 1 for e in spans)
    counters = {e["name"] for e in evs if e["ph"] == "C"}
    assert any(n.startswith("V[") for n in counters)
    assert "sched.queue_depth" in counters
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)


def test_summary_markdown_renders(port_trace, tmp_path):
    rec, _ = port_trace
    md = rec.summary_markdown()
    assert "## Rail trajectories" in md
    assert "## Requests" in md
    assert "| kv " in md
    assert summary_markdown(rec.events) in md  # without the metrics table
    p, out = tmp_path / "t.jsonl", tmp_path / "t.md"
    rec.to_jsonl(p)
    assert treport.main([str(p), "--out", str(out), "--validate"]) == 0
    assert "## Event counts" in out.read_text()


def test_serve_dispatches_are_profiled(models, monkeypatch):
    """Under the profiler the serve's dispatch sites leave one row each,
    tagged ``plain`` on CPU tensors; the trace is the same without it. The
    kv rail starts below V_min, so the intervals draw masks (numpy ones)."""
    Masks(seed=1, scale=40.0).install(monkeypatch)
    rec = TraceRecorder()
    prof = obs_profile.enable(KernelProfiler())
    try:
        _serve(models, recorder=rec, start_v=0.57)
    finally:
        obs_profile.disable()
    rows = {r["name"]: r for r in prof.to_rows()}
    assert {"decode.prefill", "decode.multistep", "kv.inject_masks", "kv.commit_tokens",
            "kv.paged_gather_scrub"} <= set(rows)
    assert all(r["backend"] == "plain" and r["calls"] >= 1 for r in rows.values())
    assert [g["name"] for g in prof.gauge_rows()] == ["serve.scrub_overlap_frac"]
    Masks(seed=1, scale=40.0).install(monkeypatch)  # the same draws again
    plain = TraceRecorder()
    _serve(models, recorder=plain, start_v=0.57)
    assert rec.to_jsonl() == plain.to_jsonl()
    assert any(e["corrected"] for e in rec.of_kind("kv_scrub"))


def test_autotune_rail_steps_advance_clock(models):
    """Autotune rounds advance the step clock; one rail_step per round."""
    _, _, tcfg, tparams, _ = models
    rec = TraceRecorder()
    eng = teng.ServingEngine(
        tcfg, tparams,
        rel=teng.ReliabilityConfig(mode="inline", voltage=0.62, seed=1),
        max_len=64, device="cpu", recorder=rec,
    )
    eng.autotune_voltage(max_rounds=4)
    steps = rec.of_kind("rail_step")
    assert steps and len(steps) == len(eng.controller.history)
    assert [e["step"] for e in steps] == sorted(e["step"] for e in steps)
    assert rec.step >= len(steps)
    assert {e["action"] for e in steps} <= {"hold", "lower", "drift+backoff", "trip+backoff",
                                            "floor"}


# ---------------------------------------------------------------------------
# the trace against the reference's, event for event and byte for byte
# ---------------------------------------------------------------------------
PARITY = {
    # multi-rail autotune from 0.62 V, then a walk_kv shared-prefix serve in
    # a 6-page arena (one preemption; dense faults: the kv canary trips)
    "walk_kv_shared": dict(
        rails=dict(multi_rail=True, start_v=0.62), autotune=6, scale=400.0, reqs=SHARED,
        serve=dict(n_lanes=2, n_pages=6, walk_kv=True, kv_voltage=0.57, share_prefix=True,
                   scrub_interval=1),
    ),
    # a speculative serve on a single-rail engine at a 0.55 V kv rail (one
    # prompt length: one prefill shape for the reference to compile)
    "speculative": dict(
        rails=dict(multi_rail=False), autotune=0, scale=6.0,
        reqs=[(PROMPTS[i][:6], 6 + i) for i in range(4)],
        serve=dict(n_lanes=2, kv_voltage=0.55, speculative=3, scrub_interval=4),
    ),
}


def _parity_run(models, case):
    cfg, params, tcfg, tparams, (dcfg, dparams, tdcfg, tdparams) = models
    spec = PARITY[case]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        Masks(seed=len(case), scale=spec["scale"]).install(mp)
        for pkg in ("ref", "port"):
            kw = dict(spec["serve"], page_tokens=PT)
            if pkg == "ref":
                rec = JRecorder()
                rel = JRel(platform="vc707", voltage=1.0, mode="inline",
                           rails=JRails(**spec["rails"]))
                eng = JEngine(cfg, params, rel=rel, max_len=MAX_LEN, recorder=rec)
                draft = dict(draft_params=dparams, draft_cfg=dcfg)
            else:
                rec = TraceRecorder()
                rel = teng.ReliabilityConfig(platform="vc707", voltage=1.0, mode="inline",
                                             rails=teng.RailsConfig(**spec["rails"]))
                eng = teng.ServingEngine(tcfg, tparams, rel=rel, max_len=MAX_LEN,
                                         device="cpu", recorder=rec)
                draft = dict(draft_params=tdparams, draft_cfg=tdcfg)
            if spec["autotune"]:
                eng.autotune_voltage(max_rounds=spec["autotune"])
            if kw.get("speculative"):
                kw.update(draft)
            out[pkg] = (rec, eng.serve(spec["reqs"], **kw))
    return out


@pytest.fixture(scope="module")
def parity(models):
    return {case: _parity_run(models, case) for case in PARITY}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_trace_jsonl_equals_reference(parity, case, tmp_path):
    (jrec, jrep), (trec, trep) = parity[case]["ref"], parity[case]["port"]
    jp, tp = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    jrec.to_jsonl(jp)
    trec.to_jsonl(tp)
    assert tp.read_bytes() == jp.read_bytes()
    assert validate_events(read_jsonl(tp)) == len(trec.events)
    kinds = {e["kind"] for e in trec.events}
    assert {"serve_begin", "admit", "retire", "kv_scrub", "gauge", "serve_end"} <= kinds
    assert len(trec.of_kind("kv_scrub")) == len(trep.kv_voltages) > 0
    assert trep.kv_stats.corrected > 0
    if case == "walk_kv_shared":
        assert trep.preemptions >= 1 and trep.prefix_hit_tokens > 0
        assert {"preempt", "prefix_hit", "trie_insert", "trie_evict", "page_grow",
                "rail_step"} <= kinds
        assert trep.kv_stats.detected > 0
        assert {e["domain"] for e in trec.of_kind("rail_step")} == {
            "attention", "mlp", "embedding", "kv"}
    else:
        assert trep.spec_dispatches > 0
        assert len(trec.of_kind("spec_block")) == trep.spec_dispatches


@pytest.mark.parametrize("case", sorted(PARITY))
@pytest.mark.parametrize("export", ["metrics", "summary", "chrome"])
def test_exports_equal_reference(parity, case, export):
    (jrec, _), (trec, _) = parity[case]["ref"], parity[case]["port"]
    if export == "metrics":
        assert trec.metrics.to_dict() == jrec.metrics.to_dict()
        assert json.dumps(trec.metrics.to_dict()) == json.dumps(jrec.metrics.to_dict())
    elif export == "summary":
        assert trec.summary_markdown() == jrec.summary_markdown()
    else:
        assert json.dumps(trec.to_chrome_trace(), sort_keys=True) == json.dumps(
            jrec.to_chrome_trace(), sort_keys=True)


@pytest.mark.parametrize("case", sorted(PARITY))
def test_report_render_equals_reference(parity, case, tmp_path):
    (jrec, _), (trec, _) = parity[case]["ref"], parity[case]["port"]
    jp, tp = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    jrec.to_jsonl(jp)
    trec.to_jsonl(tp)
    assert treport.render(tp, validate=True) == jreport.render(jp, validate=True)
