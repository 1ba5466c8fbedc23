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
serving/steps.py and the arena's methods. Not ported: the mesh's
``MeshServeReport``/``partition_requests``, the flight recorder and codec
escalation (``helpers_factory``).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.core.controller import reader_weighted_stats
from repro_torch.core.kvpages import (
    KVGeometry,
    KVPageArena,
    PageAllocator,
    PrefixTrie,
    dedup_page_table,
    row_bases,
)
from repro_torch.core.telemetry import FaultStats
from repro_torch.kernels.backend import to_device


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


class ContinuousBatchingScheduler:
    """Host-side lane + page bookkeeping (admit / grow / preempt / retire)."""

    def __init__(self, requests, n_lanes: int, alloc: PageAllocator, geom: KVGeometry,
                 arena: KVPageArena | None = None, trie: PrefixTrie | None = None):
        self.waiting = deque(RequestState(r) for r in requests)
        self.lanes: list = [None] * n_lanes
        self.alloc = alloc
        self.geom = geom
        self.arena = arena  # wipes recycled pages before reuse
        self.trie = trie  # prefix-sharing radix tree (None: private pages)
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
            yield lane, st, seq

    def ensure_pages(self, st: RequestState, until: int | None = None) -> bool:
        """Pages for positions up to ``until`` (default: the position the
        next decode step writes), preempting younger requests under
        pressure. False if ``st`` itself was preempted."""
        until = st.stored if until is None else until
        while until // self.geom.page_tokens >= len(st.pages):
            page = self._alloc(st.rid)
            if page is not None:
                st.pages.append(page)
                continue
            victim = max(self.running, key=lambda s: s.admit_seq)
            self.preempt(victim)
            if victim is st:
                return False
        return True

    def preempt(self, st: RequestState) -> None:
        """Recompute-style preemption: drop pages, re-queue at the front."""
        self.alloc.free(st.pages, st.rid)
        self.lanes[st.lane] = None
        st.pages, st.lane, st.admit_seq = [], -1, -1
        st.shared_tokens = 0
        st.status = "waiting"
        st.preemptions += 1
        self.preemptions += 1
        self.waiting.appendleft(st)

    def retire(self, st: RequestState) -> None:
        self.alloc.free(st.pages, st.rid)
        self.lanes[st.lane] = None
        st.pages, st.lane = [], -1
        st.shared_tokens = 0
        st.status = "finished"
        self.finished[st.rid] = st


def serve_stream(params, cfg, helpers, arena: KVPageArena, requests, *, n_lanes: int,
                 max_len: int, scrub_interval: int = 1, max_block: int = 16,
                 kv_controller=None, init_cache_fn=None, share_prefix: bool = False,
                 speculative: int = 0, draft_params=None, draft_cfg=None) -> ServeReport:
    """Drive a request stream to completion over the paged cache.

    ``helpers`` comes from serving/steps.make_paged_helpers;
    ``kv_controller`` (optional UndervoltController) is fed each interval's
    scrub telemetry and its voltage is applied to the arena (the `kv` rail
    walk).

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

    An interval's counter harvest (the host's wait for the counters, and
    all stats and controller work) is deferred to just before the next
    interval's tick, so the decode blocks in between are queued behind the
    scrub without waiting for it: the reference's ``scrub_overlap`` mode.
    The controller's rail move still lands before the next injection,
    attribution is captured at dispatch, and the device work is the same
    launches in the same order, so outputs, counters and rail walks equal
    the reference's serialized mode too. Each interval's counters are a
    tensor of their own, which no later launch writes.
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
    trie = PrefixTrie(alloc, geom.page_tokens) if share_prefix else None
    sched = ContinuousBatchingScheduler(requests, n_lanes, alloc, geom, arena=arena, trie=trie)
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
    pending_scrub = None  # the deferred harvest of the last interval

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
        return cap

    def _harvest_scrub(cap):
        """The deferred half: wait for the counters, then stats and the
        controller's rail move."""
        cnt = cap["cnt"].cpu().numpy()
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
            arena.set_voltage(kv_controller.update(reader_weighted_stats(interval, physical)))
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
            pending_scrub = _dispatch_scrub()

    if pending_scrub is not None:
        _harvest_scrub(pending_scrub)

    if trie is not None:
        # The prefix cache ends with the stream: release every trie
        # reference before the free-page accounting.
        trie.drain()
        sched.alloc.recycle()
    return ServeReport(
        outputs={rid: np.asarray(st.tokens, np.int32) for rid, st in sched.finished.items()},
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
