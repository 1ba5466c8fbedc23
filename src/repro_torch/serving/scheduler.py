"""Continuous-batching scheduler over the paged ECC KV cache (SECDED by default).

A fixed number of batch lanes decode in lock-step, each at its own position:

  * requests are admitted FCFS into free lanes when the page arena has room
    for their prompt plus one decode page; admissions of equal (prompt
    length, shared tokens) prefill together;
  * each lane's KV is committed token by token into ECC pages
    (core/kvpages.py), pages allocated as a request crosses a page boundary;
  * under page pressure the youngest running request is preempted
    (recompute: pages freed, request re-queued at the front and re-prefilled
    on re-admission), so the oldest requests always progress;
  * every ``scrub_interval`` steps the arena injects the `kv` rail's
    interval faults, every live page is scrubbed on read (corrected planes
    written back, per-page counters attributed to the owning request), and
    the lane caches are refreshed from the corrected payload; the interval's
    counters can drive the `kv` rail of a MultiRailController.

Scheduling is host logic; device work goes through the helpers of
serving/steps.py and the arena's methods. An optional flight recorder
(obs.TraceRecorder) gets every admission, prefix hit, page growth,
preemption, retirement, speculative block and interval scrub as an event on
its step clock, which advances with decode progress, and the ``serve.*``,
``request.*``, ``spec.*`` and ``kv.scrub.*`` metrics; it reads only values
the host already holds. When the `kv` rail escalates its code, the arena is
re-protected under it right after the scrub that flushed it, and a helpers
factory rebuilds the commit path.

A mesh engine serves data-parallel: ``partition_requests`` deals the stream
round-robin to the reliability shards, each shard runs ``serve_stream`` over
its own KV arena, and ``MeshServeReport.merge`` joins their reports (request
ids stay global).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.controller import reader_weighted_stats
from repro_torch.core.kvpages import (
    KVGeometry,
    KVPageArena,
    PageAllocator,
    PrefixTrie,
    SharedPageDEDError,
    dedup_page_table,
    row_bases,
)
from repro_torch.core.telemetry import FaultStats
from repro_torch.kernels.backend import to_device
from repro_torch.obs import profile as obs_profile


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: a prompt and a greedy-decode budget."""

    rid: int
    prompt: np.ndarray  # (s0,) int32
    max_new_tokens: int


ServeRequest = Request


@dataclasses.dataclass
class RequestState:
    req: Request
    status: str = "waiting"  # waiting | running | finished
    lane: int = -1
    admit_seq: int = -1  # admission order; preemption evicts the youngest
    pages: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)  # generated so far
    stats: FaultStats = dataclasses.field(default_factory=FaultStats)
    preemptions: int = 0
    shared_tokens: int = 0  # leading tokens served from trie-shared pages
    # flight-recorder step-clock values (-1: never, or not traced)
    admit_step: int = -1  # at the first admission (re-admissions keep it)
    first_token_step: int = -1
    finish_step: int = -1

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def stored(self) -> int:
        """Tokens whose KV lives in pages: prompt + fed decode tokens (the
        freshest token's KV is written when it is fed to the next step)."""
        return len(self.req.prompt) + max(len(self.tokens) - 1, 0)

    @property
    def resume_seq(self) -> np.ndarray:
        """Token sequence a (re-)admission prefills: prompt + every generated
        token but the last."""
        gen = np.asarray(self.tokens[:-1], np.int32)
        return np.concatenate([self.req.prompt.astype(np.int32), gen])

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.req.max_new_tokens


@dataclasses.dataclass
class ServeReport:
    """Outcome of one ``serve_stream`` run."""

    outputs: dict  # rid -> (max_new_tokens,) np.int32 generated tokens
    request_stats: dict  # rid -> FaultStats (scrub-on-read telemetry)
    kv_stats: FaultStats  # aggregate cache telemetry
    steps: int  # batched decode steps executed
    preemptions: int
    kv_voltages: list  # kv rail trajectory (one entry per scrub interval)
    arena: KVPageArena
    pages_free_at_end: int  # == arena.n_pages unless the allocator leaked
    prefix_hit_tokens: int = 0  # prompt tokens served from shared pages
    spec_dispatches: int = 0  # speculative verify blocks executed
    spec_emitted: int = 0  # tokens emitted by speculative blocks


def normalize_requests(requests) -> list:
    """(prompt, max_new_tokens) pairs -> Requests with stream-order rids
    (Requests pass through)."""
    return [
        r if isinstance(r, Request) else Request(i, np.asarray(r[0], np.int32), int(r[1]))
        for i, r in enumerate(requests)
    ]


def partition_requests(requests, n_shards: int) -> list:
    """Round-robin the stream across ``n_shards`` data-parallel replicas by
    arrival index: each replica's queue keeps the global FCFS order, and a
    one-shard mesh gets the whole stream in order."""
    assert n_shards >= 1, n_shards
    parts: list = [[] for _ in range(n_shards)]
    for i, r in enumerate(requests):
        parts[i % n_shards].append(r)
    return parts


@dataclasses.dataclass
class MeshServeReport:
    """The merged outcome of one data-parallel mesh serve: each shard's
    ServeReport stays whole in ``by_shard`` (the per-chip counters and kv
    rail trajectories), beside the merged views of the stream."""

    by_shard: list  # ServeReport per reliability shard
    outputs: dict  # rid -> generated tokens, merged across shards
    request_stats: dict  # rid -> FaultStats, merged across shards
    kv_stats: FaultStats  # cross-shard aggregate cache telemetry
    shard_of: dict  # rid -> the shard that served it
    steps: int  # decode steps over all shards
    preemptions: int

    @property
    def kv_stats_by_shard(self) -> list:
        """Per-chip cache telemetry, tagged with its shard."""
        return [dataclasses.replace(r.kv_stats, shard=s) for s, r in enumerate(self.by_shard)]

    @property
    def kv_voltages_by_shard(self) -> list:
        return [list(r.kv_voltages) for r in self.by_shard]

    @classmethod
    def merge(cls, reports) -> "MeshServeReport":
        """Join per-shard reports (shard order); a request served by two
        shards is an error."""
        reports = list(reports)
        outputs, request_stats, shard_of = {}, {}, {}
        for s, r in enumerate(reports):
            for rid, toks in r.outputs.items():
                assert rid not in outputs, f"request {rid} served twice"
                outputs[rid] = toks
                shard_of[rid] = s
            request_stats.update(r.request_stats)
        return cls(
            by_shard=reports, outputs=outputs, request_stats=request_stats,
            kv_stats=FaultStats.summed(r.kv_stats for r in reports), shard_of=shard_of,
            steps=sum(r.steps for r in reports),
            preemptions=sum(r.preemptions for r in reports),
        )


class ContinuousBatchingScheduler:
    """Host-side lane + page bookkeeping (admit / grow / preempt / retire)."""

    def __init__(self, requests, n_lanes: int, alloc: PageAllocator, geom: KVGeometry,
                 arena: KVPageArena | None = None, trie: PrefixTrie | None = None,
                 recorder=None):
        self.waiting = deque(RequestState(r) for r in requests)
        self.lanes: list = [None] * n_lanes
        self.alloc = alloc
        self.geom = geom
        self.arena = arena  # wipes recycled pages before reuse
        self.trie = trie  # prefix-sharing radix tree (None: private pages)
        self.recorder = recorder  # optional obs.TraceRecorder
        self.shard = arena.shard if arena is not None else -1
        self.finished: dict = {}
        self.preemptions = 0
        self._admit_counter = 0
        self.fresh_pages: list = []  # allocated since the last wipe

    def _alloc(self, owner):
        """A page for ``owner``: recycles the dirty list when the clean list
        runs dry, after evicting a sole-referenced trie leaf; every
        allocation is recorded for the next wipe."""
        page = self.alloc.alloc(owner)
        if page is None and self.trie is not None and not self.alloc.dirty_pages:
            self.trie.evict_lru(1)
        if page is None and self.alloc.dirty_pages:
            self.alloc.recycle()
            page = self.alloc.alloc(owner)
        if page is not None:
            self.fresh_pages.append(page)
        return page

    def drain_fresh_pages(self) -> None:
        """Wipe the pages allocated since the last drain (no-op before the
        arena first faulted)."""
        if self.fresh_pages and self.arena is not None and self.arena.faulted:
            self.arena.zero_pages(np.asarray(self.fresh_pages, np.int32))
        self.fresh_pages.clear()

    @property
    def running(self) -> list:
        return [st for st in self.lanes if st is not None]

    @property
    def unfinished(self) -> bool:
        return bool(self.waiting) or any(self.lanes)

    def _free_lane(self):
        for i, st in enumerate(self.lanes):
            if st is None:
                return i
        return None

    def admit(self):
        """Admit waiting requests FCFS while lanes and pages allow; yields
        (lane, state, resume_seq) with pages covering the prefilled sequence
        plus the first decode token. With a trie, the longest cached
        full-page prefix is shared instead of allocated."""
        while self.waiting:
            lane = self._free_lane()
            if lane is None:
                break
            st = self.waiting[0]
            seq = st.resume_seq
            shared: list = []
            if self.trie is not None:
                shared = self.trie.lookup(seq)
                for p in shared:
                    self.alloc.share(p, st.rid)
            need = self.geom.pages_for(len(seq) + 1) - len(shared)
            if need > self.alloc.free_pages and self.trie is not None:
                self.trie.evict_lru(need - self.alloc.free_pages)
            if need > self.alloc.free_pages:
                if shared:
                    self.alloc.free(shared, st.rid)  # undo; retry next round
                break
            self.waiting.popleft()
            st.pages = shared + [self._alloc(st.rid) for _ in range(need)]
            st.shared_tokens = len(shared) * self.geom.page_tokens
            st.status, st.lane = "running", lane
            st.admit_seq = self._admit_counter
            self._admit_counter += 1
            self.lanes[lane] = st
            rec = self.recorder
            if rec:
                if st.admit_step < 0:
                    st.admit_step = rec.step
                rec.emit(
                    "admit", request_id=st.rid, shard=self.shard, lane=lane,
                    prompt_len=len(seq), shared_tokens=st.shared_tokens,
                )
                rec.metrics.counter("serve.admissions").inc()
                if shared:
                    rec.emit(
                        "prefix_hit", request_id=st.rid, shard=self.shard,
                        tokens=st.shared_tokens, pages=len(shared),
                    )
            yield lane, st, seq

    def ensure_pages(self, st: RequestState, until: int | None = None) -> bool:
        """Pages for positions up to ``until`` (default: the position the
        next decode step writes), preempting younger requests under
        pressure. False if ``st`` itself was preempted."""
        until = st.stored if until is None else until
        added = 0
        while until // self.geom.page_tokens >= len(st.pages):
            page = self._alloc(st.rid)
            if page is not None:
                st.pages.append(page)
                added += 1
                continue
            victim = max(self.running, key=lambda s: s.admit_seq)
            self.preempt(victim)
            if victim is st:
                return False
        if added and self.recorder:
            self.recorder.emit(
                "page_grow", request_id=st.rid, shard=self.shard,
                pages_added=added, pages_total=len(st.pages),
            )
        return True

    def preempt(self, st: RequestState) -> None:
        """Recompute-style preemption: drop pages, re-queue at the front."""
        if self.recorder:
            self.recorder.emit(
                "preempt", request_id=st.rid, shard=self.shard, lane=st.lane,
                pages_freed=len(st.pages), preemptions=st.preemptions + 1,
            )
        self.alloc.free(st.pages, st.rid)
        self.lanes[st.lane] = None
        st.pages, st.lane, st.admit_seq = [], -1, -1
        st.shared_tokens = 0
        st.status = "waiting"
        st.preemptions += 1
        self.preemptions += 1
        self.waiting.appendleft(st)

    def retire(self, st: RequestState) -> None:
        rec = self.recorder
        if rec:
            st.finish_step = rec.step
            lat = rec.step - st.admit_step if st.admit_step >= 0 else 0
            rec.emit(
                "retire", request_id=st.rid, shard=self.shard,
                tokens=len(st.tokens), latency_steps=lat,
                first_token_step=st.first_token_step, preemptions=st.preemptions,
            )
            rec.metrics.histogram("request.latency_steps").observe(lat)
            if st.first_token_step >= 0 and st.admit_step >= 0:
                rec.metrics.histogram("request.first_token_steps").observe(
                    st.first_token_step - st.admit_step
                )
        self.alloc.free(st.pages, st.rid)
        self.lanes[st.lane] = None
        st.pages, st.lane = [], -1
        st.shared_tokens = 0
        st.status = "finished"
        self.finished[st.rid] = st


def serve_stream(params, cfg, helpers, arena: KVPageArena, requests, *, n_lanes: int,
                 max_len: int, scrub_interval: int = 1, max_block: int = 16,
                 kv_controller=None, init_cache_fn=None, helpers_factory=None,
                 share_prefix: bool = False, speculative: int = 0, draft_params=None,
                 draft_cfg=None, recorder=None,
                 scrub_overlap: bool | None = None) -> ServeReport:
    """Drive a request stream to completion over the paged cache.

    ``helpers`` comes from serving/steps.make_paged_helpers (any
    ``DecodeBlockHelpers``); ``kv_controller`` (optional
    UndervoltController) is fed each interval's scrub telemetry and its
    voltage is applied to the arena (the `kv` rail walk). When it escalates
    its code, the arena is re-encoded under the new code and
    ``helpers_factory`` (codec name -> helpers, ``steps.HelpersFactory``)
    gives the commit path that matches it. Without a factory a stronger code
    cannot be applied to the live arena, so escalation is suppressed around
    each controller update (and the caller's policy restored after it): the
    controller never runs ahead of the protection in force.

    Decode runs in blocks of up to ``max_block`` steps: the largest power of
    two that no active lane's remaining budget and no pending scrub deadline
    cuts short.

    ``share_prefix`` turns on the prefix-sharing trie: identical full-page
    prompt prefixes map to the same physical pages, admission scrubs the
    shared pages once and chunk-prefills only the private suffix, and the
    interval scrub scrubs each unique page once while the kv controller is
    fed reader-weighted counters.

    ``speculative=K`` (with ``draft_params``/``draft_cfg``) drafts K-1
    tokens per block and verifies all K in one chunked target forward; only
    accepted tokens' pages are committed, so the output is greedy decode's.

    ``scrub_overlap=True`` defers an interval's counter harvest (the host's
    wait for the counters, and all stats and controller work) to just
    before the next interval's tick, so the decode blocks in between are
    queued behind the scrub without waiting for it; ``False`` harvests right
    after the dispatch (serialized). The controller's rail move lands before
    the next injection either way, attribution is captured at dispatch, and
    the device work is the same launches in the same order, so outputs,
    counters and rail walks are equal in both modes. Each interval's
    counters are a tensor of their own, which no later launch writes.
    ``None`` overlaps unless escalation is live (a ``kv_controller`` with a
    ladder and a ``helpers_factory``), and then runs serialized: a deferred
    harvest would apply a code change after the next decode block had
    committed under the old code, so such streams are demoted.

    ``recorder`` (optional obs.TraceRecorder) traces the stream: its clock
    advances by each decode block's steps (a speculative block by its
    furthest lane's emitted tokens, at least 1), never inside the scrub;
    the interval's ``kv_scrub`` event and gauges are emitted at its harvest,
    the gauges as of its dispatch.
    """
    geom = arena.geom
    dev = arena.device
    requests = normalize_requests(requests)
    for r in requests:
        total = len(r.prompt) + r.max_new_tokens
        assert total <= max_len, (r.rid, total, max_len)
        assert geom.pages_for(total) <= arena.n_pages, (
            f"request {r.rid} needs {geom.pages_for(total)} pages, arena has {arena.n_pages}"
        )
        assert r.max_new_tokens >= 1 and len(r.prompt) >= 1

    from repro_torch.models import lm
    from repro_torch.serving import steps as steps_mod

    init_cache_fn = init_cache_fn or (lambda b: lm.init_cache(cfg, b, max_len, device=dev))
    alloc = PageAllocator(arena.n_pages)
    rec = recorder
    trie = (
        PrefixTrie(alloc, geom.page_tokens, recorder=rec, shard=arena.shard)
        if share_prefix else None
    )
    sched = ContinuousBatchingScheduler(
        requests, n_lanes, alloc, geom, arena=arena, trie=trie, recorder=rec
    )
    if rec:
        rec.emit(
            "serve_begin", shard=arena.shard, n_requests=len(requests),
            n_lanes=n_lanes, scrub_interval=scrub_interval,
            share_prefix=bool(share_prefix), speculative=int(speculative),
            voltage=float(arena.voltage), codec=arena.codec_name,
        )
    spec_k = int(speculative)
    if spec_k >= 2:
        assert draft_params is not None and draft_cfg is not None, (
            "speculative decode needs draft_params + draft_cfg"
        )
        assert helpers.get("spec_multistep") is not None, (
            "helpers were built without a draft config (spec_multistep)"
        )
        draft_prefill = steps_mod.make_prefill_step(draft_cfg)
        dcache = lm.init_cache(draft_cfg, n_lanes, max_len, device=dev)
    else:
        draft_prefill, dcache = None, None
    cache = init_cache_fn(n_lanes)
    cur_tok = np.zeros(n_lanes, np.int64)
    pos_v = np.zeros(n_lanes, np.int64)
    steps = 0
    since_scrub = 0
    kv_voltages: list = []
    prefix_hit_tokens = 0
    spec_dispatches = 0
    spec_emitted = 0
    overlap = scrub_overlap
    if overlap is None:
        # Demotion (see the docstring): a code change rebinds the commit
        # path, which must happen with the scrub that flushed the arena.
        overlap = not (
            kv_controller is not None and helpers_factory is not None
            and kv_controller.escalation is not None
        )
    pending_scrub = None  # the deferred harvest of the last interval (overlap)

    def _dispatch_scrub():
        """Interval scrub device work (tick, scrub-on-read, cache refresh),
        queued without waiting for it. Returns what the harvest needs: the
        device counters and the attribution as of this interval."""
        nonlocal cache
        arena.tick()
        # Table width follows the live page maximum, power-of-two bucketed.
        live_max = max(len(st.pages) for st in sched.running)
        p_cols = 1 << max(live_max - 1, 0).bit_length()
        table = np.full((n_lanes, p_cols), arena.scratch_page, np.int32)
        n_tok = np.zeros(n_lanes, np.int64)
        lanes_cap: list = []
        for i, st in enumerate(sched.lanes):
            if st is None:
                lanes_cap.append(None)
                continue
            table[i, : len(st.pages)] = st.pages
            n_tok[i] = st.stored
            lanes_cap.append((st, len(st.pages)))
        n_tok_d = to_device(n_tok, dev)
        if trie is None:
            payload, cnt = arena.scrub_pages_async(table.reshape(-1))
            cache = helpers["refresh"](cache, payload.reshape(n_lanes, -1, geom.token_f32), n_tok_d)
            cap = {"mode": "private", "cnt": cnt, "p_cols": p_cols}
        else:
            # Scrub each unique live page once, fan the payload out to every
            # reader's lane.
            upad, rows, n_u = dedup_page_table(table, arena.scratch_page)
            payload_u, cnt = arena.scrub_pages_async(upad)
            rows_d = to_device(rows.reshape(-1).astype(np.int64), dev)
            cache = helpers["refresh"](
                cache, payload_u[rows_d].reshape(n_lanes, -1, geom.token_f32), n_tok_d
            )
            cap = {"mode": "shared", "cnt": cnt, "rows": rows, "n_u": n_u}
        cap["lanes"] = lanes_cap
        # The gauges describe the interval being scrubbed: at the harvest
        # the scheduler has moved on.
        cap["gauges"] = (sched.alloc.free_pages, len(sched.waiting), len(sched.running))
        cap["t_dispatch"] = time.perf_counter()
        return cap

    def _harvest_scrub(cap):
        """The harvest: wait for the counters, then stats, the controller's
        rail move (and a code change) and the recorder's events."""
        nonlocal helpers
        t0 = time.perf_counter()
        cnt = cap["cnt"].cpu().numpy()
        if overlap and obs_profile.active():
            # The share of the dispatch-to-counters window that the decode
            # blocks covered; the rest the host waited on the scrub.
            t1 = time.perf_counter()
            span = max(t1 - cap["t_dispatch"], 1e-9)
            obs_profile.gauge("serve.scrub_overlap_frac", (t0 - cap["t_dispatch"]) / span)
        interval = FaultStats()  # reader-weighted attribution
        if cap["mode"] == "private":
            cnt = cnt.reshape(n_lanes, cap["p_cols"], 8)
            for i, lc in enumerate(cap["lanes"]):
                if lc is None:
                    continue
                st, n_p = lc
                rs = FaultStats.from_counters(
                    cnt[i, :n_p].sum(axis=0), words=n_p * geom.words_per_page
                )
                st.stats.accumulate(rs)
                interval.accumulate(rs)
            physical = interval  # one reader per page
            arena.stats.accumulate(interval)
        else:
            rows, n_u = cap["rows"], cap["n_u"]
            for i, lc in enumerate(cap["lanes"]):
                if lc is None:
                    continue
                st, n_p = lc
                rs = FaultStats.from_counters(
                    cnt[rows[i, :n_p]].sum(axis=0), words=n_p * geom.words_per_page
                )
                st.stats.accumulate(rs)
                interval.accumulate(rs)
            physical = FaultStats.from_counters(
                cnt[:n_u].sum(axis=0), words=n_u * geom.words_per_page
            )
            arena.stats.accumulate(physical)
        if kv_controller is not None and not kv_controller.locked:
            saved_policy = kv_controller.escalation
            if helpers_factory is None:
                kv_controller.escalation = None
            try:
                arena.set_voltage(kv_controller.update(reader_weighted_stats(interval, physical)))
            finally:
                kv_controller.escalation = saved_policy
            change = kv_controller.pop_codec_change()
            if change:
                if rec:
                    rec.emit("kv_codec_change", shard=arena.shard, domain="kv", codec=change)
                # Re-protect right after the scrub above flushed every
                # correctable fault; the commit path switches with it.
                shared_now = None
                if trie is not None:
                    shared_now = sorted(set(sched.alloc.shared_pages()) | set(trie.pages()))
                try:
                    arena.change_codec(change, shared_pages=shared_now)
                except SharedPageDEDError as err:
                    # Refuse-and-copy: a latched DED on a shared page is not
                    # sealed for its readers. Drop the trie's claim, preempt
                    # every running reader (recompute is the copy), then
                    # re-protect.
                    trie.evict_pages(err.pages)
                    bad = set(err.pages)
                    preempted = 0
                    for st in list(sched.running):
                        if bad & set(st.pages):
                            sched.preempt(st)
                            preempted += 1
                    arena.change_codec(change)
                    if rec:
                        rec.emit("shared_ded_recovery", shard=arena.shard, domain="kv",
                                 pages=len(err.pages), preempted=preempted)
                helpers = helpers_factory(change)
        if rec:
            rec.emit(
                "kv_scrub", shard=arena.shard, domain="kv",
                interval=len(kv_voltages), voltage=float(arena.voltage),
                codec=arena.codec_name, corrected=physical.corrected,
                detected=physical.detected, silent=physical.silent, words=physical.words,
            )
            m = rec.metrics
            lbl = {"shard": arena.shard} if arena.shard >= 0 else {}
            m.observe_fault_stats("kv.scrub", physical, **lbl)
            for gname, val in zip(("kv.pages_free", "sched.queue_depth", "sched.lanes_active"),
                                  cap["gauges"]):
                m.gauge(gname, **lbl).set(val)
                rec.emit("gauge", shard=arena.shard, name=gname, value=val)
        kv_voltages.append(arena.voltage)

    while sched.unfinished:
        # -- admission: batch same-shape prefills, commit the prompts' KV --
        groups: dict = {}
        for lane, st, seq in sched.admit():
            groups.setdefault((len(seq), st.shared_tokens), []).append((lane, st, seq))
        sched.drain_fresh_pages()  # wipe before the prompt commits below
        for (s0, sh), grp in groups.items():
            m = len(grp)
            cachem = init_cache_fn(m)
            seqs = np.stack([seq for _, _, seq in grp])
            seqs_d = to_device(seqs.astype(np.int64), dev)
            if sh:
                # Prefix hit: scrub the shared pages once, refresh their
                # payload into the batch cache, chunk-prefill the suffix.
                n_sp = sh // geom.page_tokens
                ptab = np.stack([st.pages[:n_sp] for _, st, _ in grp])
                upad, rows, n_u = dedup_page_table(ptab, arena.scratch_page)
                payload_u, cnt_u = arena.scrub_pages(upad)
                rows_d = to_device(rows.reshape(-1).astype(np.int64), dev)
                payload = payload_u[rows_d].reshape(m, sh, geom.token_f32)
                sh_d = torch.full((m,), sh, dtype=torch.int64, device=dev)
                cachem = helpers["refresh"](cachem, payload, sh_d)
                tokm, cachem = helpers["chunk"](params, seqs_d[:, sh:], cachem, sh_d,
                                                max_pos=sh)
                payload_sfx = helpers["extract_span"](cachem, start=sh, stop=s0)
                tok_idx = np.arange(sh, s0)
                arena.stats.accumulate(
                    FaultStats.from_counters(
                        cnt_u[:n_u].sum(axis=0), words=n_u * geom.words_per_page
                    )
                )
                for r, (_, st, _) in zip(rows, grp):
                    st.stats.accumulate(
                        FaultStats.from_counters(
                            cnt_u[r].sum(axis=0), words=n_sp * geom.words_per_page
                        )
                    )
                prefix_hit_tokens += sh * m
            else:
                tokm, cachem = helpers["prefill"](params, seqs_d, cachem)
                payload_sfx = helpers["extract_range"](cachem, s0=s0)
                tok_idx = np.arange(s0)
            page_ids = np.stack(
                [[st.pages[t // geom.page_tokens] for t in tok_idx] for _, st, _ in grp]
            )
            arena.commit_tokens(
                payload_sfx.reshape(m * len(tok_idx), -1),
                page_ids.reshape(-1),
                np.tile(tok_idx % geom.page_tokens, m),
            )
            if trie is not None:
                # register the prompts' complete pages (partial tail pages
                # stay private: divergence is copy-on-write)
                for _, st, seq in grp:
                    trie.insert(seq, st.pages[: len(seq) // geom.page_tokens])
            if draft_prefill is not None:
                dcachem = lm.init_cache(draft_cfg, m, max_len, device=dev)
                _, dcachem = draft_prefill(draft_params, seqs_d, dcachem)
            tok_host = tokm.cpu().numpy().reshape(-1)
            for row, (lane, st, _) in enumerate(grp):
                cache = helpers["load_lane"](cache, cachem, row, lane)
                if draft_prefill is not None:
                    dcache = helpers["load_lane"](dcache, dcachem, row, lane)
                if not st.tokens:  # fresh admission: keep the prefill's token
                    st.tokens = [int(tok_host[row])]
                    if rec and st.first_token_step < 0:
                        st.first_token_step = rec.step
                if st.done:  # budget met by the prefill token alone
                    sched.retire(st)
                    continue
                cur_tok[lane] = st.tokens[-1]
                pos_v[lane] = s0

        # -- block size: no lane's budget, and no scrub deadline, overrun ---
        running = sched.running
        if not running:
            if not sched.unfinished:
                break
            assert sched.waiting, "deadlock: no lanes active and queue empty"
            continue
        k = min(st.req.max_new_tokens - len(st.tokens) for st in running)
        k = max(1, min(k, max_block))
        if scrub_interval:
            k = max(1, min(k, scrub_interval - since_scrub))
        k = 1 << (k.bit_length() - 1)

        # -- page growth for the whole block; preempt on pressure -----------
        for st in list(running):
            if st.status == "running":  # an earlier growth may have evicted it
                sched.ensure_pages(st, until=st.stored + k - 1)
        active = [i for i, st in enumerate(sched.lanes) if st is not None]
        if not active:
            continue
        sched.drain_fresh_pages()  # wipe growth pages before the block commits

        # -- k decode steps + per-token page commits ------------------------
        page_ids = np.full((k, n_lanes), arena.scratch_page, np.int32)
        slots = np.zeros((k, n_lanes), np.int32)
        for i in active:
            st = sched.lanes[i]
            for j in range(k):
                t = pos_v[i] + j
                page_ids[j, i] = st.pages[t // geom.page_tokens]
                slots[j, i] = t % geom.page_tokens
        tok_d = to_device(cur_tok[:, None], dev)
        pos_d = to_device(pos_v, dev)
        if spec_k >= 2 and k >= 2:
            kk = min(k, spec_k)
            scratch = np.full_like(page_ids[:kk], arena.scratch_page)
            greedy, n_emit, cache, dcache, arena.lo, arena.hi, arena.parity = (
                helpers["spec_multistep"](
                    params, draft_params, tok_d, cache, dcache,
                    arena.lo, arena.hi, arena.parity, pos_d,
                    to_device(row_bases(page_ids[:kk], slots[:kk], geom), dev),
                    to_device(row_bases(scratch, slots[:kk], geom), dev),
                    k=kk, max_pos=int(pos_v.max()),
                )
            )
            greedy_host = greedy.cpu().numpy()
            n_host = n_emit.cpu().numpy()
            steps += 1
            spec_dispatches += 1
            adv = max((int(n_host[i]) for i in active), default=0)
            if rec:
                # clock first, so the block's retirements see the step after it
                rec.advance(max(adv, 1))
                emitted = sum(int(n_host[i]) for i in active)
                rec.emit(
                    "spec_block", shard=arena.shard, k=kk, lanes=len(active),
                    emitted=emitted, slots=kk * len(active),
                )
                rec.metrics.counter("spec.slots").inc(kk * len(active))
                rec.metrics.counter("spec.emitted").inc(emitted)
            for i in active:
                st = sched.lanes[i]
                n = int(n_host[i])
                st.tokens.extend(int(t) for t in greedy_host[i, :n])
                spec_emitted += n
                cur_tok[i] = st.tokens[-1]
                pos_v[i] += n
                if st.done:
                    sched.retire(st)
            since_scrub += adv
        else:
            toks, cache, arena.lo, arena.hi, arena.parity = helpers["multistep"](
                params, tok_d, cache, arena.lo, arena.hi, arena.parity, pos_d,
                to_device(row_bases(page_ids, slots, geom), dev),
                max_pos=int(pos_v.max()),
            )
            toks_host = toks.cpu().numpy()
            steps += k
            since_scrub += k
            if rec:
                rec.advance(k)  # the clock is decode progress
            for i in active:
                st = sched.lanes[i]
                st.tokens.extend(int(t) for t in toks_host[:, i])
                cur_tok[i] = st.tokens[-1]
                pos_v[i] += k
                if st.done:
                    sched.retire(st)

        # -- scrub interval: inject at the kv rail, scrub-on-read, refresh --
        if scrub_interval and since_scrub >= scrub_interval:
            since_scrub = 0
        else:
            continue
        # Interval N's counters are harvested just before interval N+1's
        # tick, so the controller's rail move lands before the next
        # injection, as in the serialized path.
        if pending_scrub is not None:
            _harvest_scrub(pending_scrub)
            pending_scrub = None
        if sched.running:
            cap = _dispatch_scrub()
            if overlap:
                pending_scrub = cap
            else:
                _harvest_scrub(cap)

    if pending_scrub is not None:
        _harvest_scrub(pending_scrub)

    if trie is not None:
        # The prefix cache ends with the stream: release every trie
        # reference before the free-page accounting.
        trie.drain()
        sched.alloc.recycle()
    outputs = {rid: np.asarray(st.tokens, np.int32) for rid, st in sched.finished.items()}
    if rec:
        rec.emit(
            "serve_end", shard=arena.shard, steps=steps,
            preemptions=sched.preemptions, finished=len(outputs),
        )
        lbl = {"shard": arena.shard} if arena.shard >= 0 else {}
        rec.metrics.counter("serve.steps", **lbl).inc(steps)
        rec.metrics.counter("serve.preemptions", **lbl).inc(sched.preemptions)
        rec.metrics.counter("serve.prefix_hit_tokens", **lbl).inc(prefix_hit_tokens)
    return ServeReport(
        outputs=outputs,
        request_stats={rid: st.stats for rid, st in sched.finished.items()},
        kv_stats=arena.stats,
        steps=steps,
        preemptions=sched.preemptions,
        kv_voltages=kv_voltages,
        arena=arena,
        pages_free_at_end=sched.alloc.free_pages,
        prefix_hit_tokens=prefix_hit_tokens,
        spec_dispatches=spec_dispatches,
        spec_emitted=spec_emitted,
    )
