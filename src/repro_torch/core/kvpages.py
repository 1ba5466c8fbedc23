"""Paged, ECC-protected KV-cache arena (any registered codec; SECDED by
default).

The weight arena (core/planestore.py) keeps the static model state in
undervolted ECC memory; this module does the same for the dynamic state, the
KV cache, on the `kv` voltage domain.

Layout
  * The arena is a flat word store of ``n_pages`` fixed-size pages plus one
    scratch page that masked writes land on. A page holds ``page_tokens``
    tokens; one token's payload is every attention layer's K and V row for
    that position as float32, viewed as 32-bit words and packed two per
    64-bit codeword (lo = even, hi = odd f32): lo/hi int32 planes (uint32
    bit patterns) plus a check plane in the codec's check dtype (uint8 up to
    8 check bits, int32 bit patterns beyond), the word geometry of the
    weight path.
  * ``PageAllocator`` hands out pages with refcounted-owner bookkeeping;
    ``PrefixTrie`` shares full-page prompt prefixes between requests.
  * Writes encode and scatter in one launch (``kops.encode_commit``); reads
    go through the scrub-on-read kernel (``kops.gather_scrub_pages``), which
    reads the page rows by id, corrects what the codec corrects, writes the
    corrected planes back and counts (clean, corrected, detected) per page.
  * ``tick()`` injects one interval's undervolting faults at the `kv` rail
    voltage, XORed into the stored planes: the cache is mutable, so faults
    persist until a scrub corrects them or a write overwrites the cell.
  * ``change_codec`` re-protects the live arena under another code (the
    `kv` rail's escalation): shared pages are first scrubbed under the old
    code, and a DED latched on one of them refuses the change
    (``SharedPageDEDError``); otherwise the check plane is re-encoded from
    the page contents in one launch. The check plane is then a new tensor,
    of the new code's dtype: every user reads ``arena.parity`` afresh.

The planes are updated in place (the reference's arrays are immutable and
each method returns new ones): ``commit_tokens``, ``tick``, ``zero_pages``
and the scrub write-back all modify ``lo``/``hi``/``parity``.

Each interval's masks come from ``mask_fn(interval, n_words, rate,
row_sigma, n_check) -> (lo, hi, check)`` (numpy uint32 and uint8/uint32,
or tensors; an arena with a burst shape also passes ``burst=``), by default
``faultsim.interval_masks`` on the arena's device. An environment scenario
(``env=``) brings its burst shape to every interval's draw and its aging
drift to the interval's rate (the interval counter is the aging clock); its
flux is expected in the profile the caller passes, so it is never applied
twice. Not ported: mesh shards (an arena is shard 0, the reference's
default).

The interval draw, the token commit and the scrub go through the opt-in
dispatch profiler (``obs.profile.call``) under the reference's names; a
``PrefixTrie`` with a flight recorder emits ``trie_insert`` and
``trie_evict`` events.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import codes
from repro_torch.codes.base import as_words
from repro_torch.core import faultsim, scenario
from repro_torch.core.telemetry import FaultStats
from repro_torch.core.voltage import PlatformProfile
from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device, to_device
from repro_torch.obs import profile as obs_profile

PAGE_TOKENS = 8  # default page size (tokens)


def dedup_page_table(table, scratch_page: int):
    """Deduplicate a page-id table for one scrub pass.

    Returns ``(upad, rows, n_unique)``: the unique non-scratch ids ascending,
    padded with ``scratch_page`` to the next power of two (with at least one
    scratch slot when ``table`` holds scratch entries); int32 ``rows`` of
    ``table``'s shape mapping every entry to its row in ``upad``; and the
    count of real pages (``upad[:n_unique]``)."""
    table = np.asarray(table, np.int32)
    flat = table.reshape(-1)
    real = flat[flat != scratch_page]
    uniq = np.unique(real)
    n_u = len(uniq)
    has_scratch = len(real) != len(flat)
    target = 1 << max(n_u + int(has_scratch) - 1, 0).bit_length()
    upad = np.concatenate(
        [uniq, np.full(max(target, 1) - n_u, scratch_page, np.int32)]
    ).astype(np.int32)
    rows = np.where(flat == scratch_page, n_u, np.searchsorted(uniq, flat)).astype(np.int32)
    return upad, rows.reshape(table.shape), n_u


@dataclasses.dataclass(frozen=True)
class KVGeometry:
    """Word-level geometry of one model's paged KV cache."""

    attn_positions: tuple  # period positions with an attention mixer
    n_groups: int
    n_kv_heads: int
    head_dim: int
    page_tokens: int = PAGE_TOKENS

    @classmethod
    def from_config(cls, cfg, page_tokens: int = PAGE_TOKENS) -> "KVGeometry":
        attn = tuple(j for j in range(cfg.period) if cfg.layer_kind(j)["mixer"] == "attn")
        return cls(attn, cfg.n_groups, cfg.n_kv_heads, cfg.hd, int(page_tokens))

    @property
    def token_f32(self) -> int:
        """f32 values per token: K and V rows of every attention layer."""
        return 2 * len(self.attn_positions) * self.n_groups * self.n_kv_heads * self.head_dim

    @property
    def token_words(self) -> int:
        """64-bit codewords per token (two f32 per codeword)."""
        return self.token_f32 // 2

    @property
    def words_per_page(self) -> int:
        return self.page_tokens * self.token_words

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_tokens)


class PageAllocator:
    """Free-list page allocator with refcounted-owner bookkeeping.

    A page starts single-owner via ``alloc``; more readers attach with
    ``share`` and each drops only its own reference with ``free``. A page
    goes to the dirty list when its last reference drops and returns to the
    free list through ``recycle()``. ``KVPageArena.tick`` injects into every
    word, allocated or not, so the serving loop zero-wipes newly allocated
    pages once the arena has faulted."""

    def __init__(self, n_pages: int):
        self.n_pages = int(n_pages)
        self._free = list(range(self.n_pages - 1, -1, -1))  # pop() -> page 0 first
        self._dirty: list = []
        self._owners: dict = {}

    @property
    def free_pages(self) -> int:
        """Pages allocatable without preemption (clean + recyclable)."""
        return len(self._free) + len(self._dirty)

    @property
    def dirty_pages(self) -> int:
        return len(self._dirty)

    @property
    def used_pages(self) -> int:
        return self.n_pages - self.free_pages

    def owner_of(self, page: int):
        """Sole owner of a single-reader page; a frozenset for shared pages;
        None for unallocated pages."""
        owners = self._owners.get(page)
        if not owners:
            return None
        if len(owners) == 1:
            return next(iter(owners))
        return frozenset(owners)

    def refcount(self, page: int) -> int:
        return len(self._owners.get(page, ()))

    def is_shared(self, page: int) -> bool:
        return self.refcount(page) > 1

    def shared_pages(self) -> list:
        """Live pages with more than one reader, ascending."""
        return sorted(p for p, o in self._owners.items() if len(o) > 1)

    def alloc(self, owner):
        """One clean page for ``owner``; None if the clean list is empty."""
        if not self._free:
            return None
        page = self._free.pop()
        assert page not in self._owners, f"page {page} double-allocated"
        self._owners[page] = {owner}
        return page

    def share(self, page: int, owner) -> None:
        """Attach ``owner`` as an additional reader of a live page."""
        owners = self._owners.get(page)
        assert owners, f"page {page} shared while unallocated"
        assert owner not in owners, f"page {page} already referenced by {owner!r}"
        owners.add(owner)

    def free(self, pages, owner) -> None:
        """Drop ``owner``'s reference on each page; a page goes dirty only
        when its last reference drops."""
        for page in pages:
            owners = self._owners.get(page)
            assert owners is not None and owner in owners, (
                f"page {page} freed by {owner!r} but owned by {self.owner_of(page)!r}"
            )
            owners.discard(owner)
            if owners:
                continue
            del self._owners[page]
            self._dirty.append(page)

    def recycle(self) -> list:
        """Move the dirty list to the free list; returns the batch."""
        batch, self._dirty = self._dirty, []
        self._free.extend(batch)
        return batch


class _TrieNode:
    __slots__ = ("key", "page", "parent", "children", "stamp")

    def __init__(self, key, page, parent):
        self.key = key  # tuple of page_tokens token ids (None at the root)
        self.page = page  # physical page id (None at the root)
        self.parent = parent
        self.children: dict = {}
        self.stamp = 0  # LRU clock of the last lookup/insert touch


class PrefixTrie:
    """Radix tree over full-page token prefixes.

    Each edge is one page's worth of token ids, so a node at depth d names a
    d * page_tokens token prefix and carries the physical page of that
    chunk. The trie holds a reference on every registered page (owner
    ``OWNER``), so a prefix stays cached after its last reader retires;
    capacity pressure evicts sole-referenced leaves in LRU order. Only
    complete pages are registered: a request's partial tail page is private,
    which makes divergence copy-on-write. An optional flight recorder
    (obs.TraceRecorder) records registrations and evictions."""

    OWNER = "<prefix-trie>"

    def __init__(self, alloc: PageAllocator, page_tokens: int, recorder=None,
                 shard: int = -1):
        self.alloc = alloc
        self.page_tokens = int(page_tokens)
        self._root = _TrieNode(None, None, None)
        self._by_page: dict = {}
        self._clock = 0
        self.recorder = recorder
        self.shard = int(shard)

    def __len__(self) -> int:
        return len(self._by_page)

    def _chunks(self, tokens) -> list:
        pt = self.page_tokens
        toks = [int(t) for t in tokens]
        return [tuple(toks[i : i + pt]) for i in range(0, len(toks) - pt + 1, pt)]

    def lookup(self, tokens) -> list:
        """Pages of the longest cached full-page prefix of ``tokens``, capped
        at len(tokens) - 1 so at least one token is left to prefill."""
        if len(tokens) < 2:
            return []
        max_pages = (len(tokens) - 1) // self.page_tokens
        node, pages = self._root, []
        self._clock += 1
        for key in self._chunks(tokens)[:max_pages]:
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = self._clock
            pages.append(child.page)
            node = child
        return pages

    def insert(self, tokens, pages) -> None:
        """Register ``pages`` as the leading full-page chunks of ``tokens``;
        new chunks take a trie reference."""
        chunks = self._chunks(tokens)
        assert len(pages) <= len(chunks), "pages beyond full-page prefix"
        node = self._root
        self._clock += 1
        fresh = 0
        for key, page in zip(chunks, pages):
            child = node.children.get(key)
            if child is None:
                self.alloc.share(page, self.OWNER)
                child = _TrieNode(key, int(page), node)
                node.children[key] = child
                self._by_page[child.page] = child
                fresh += 1
            child.stamp = self._clock
            node = child
        if fresh and self.recorder:
            self.recorder.emit("trie_insert", shard=self.shard, pages=fresh)

    def _drop(self, node: _TrieNode) -> None:
        del node.parent.children[node.key]
        del self._by_page[node.page]
        self.alloc.free([node.page], self.OWNER)

    def evict_lru(self, n: int = 1) -> list:
        """Drop up to ``n`` sole-referenced leaves, least recently touched
        first; returns the pages released to the dirty list."""
        freed = []
        while len(freed) < n:
            victims = [
                nd for nd in self._by_page.values()
                if not nd.children and self.alloc.refcount(nd.page) == 1
            ]
            if not victims:
                break
            victim = min(victims, key=lambda nd: nd.stamp)
            freed.append(victim.page)
            self._drop(victim)
        if freed and self.recorder:
            self.recorder.emit("trie_evict", shard=self.shard, pages=len(freed), reason="lru")
        return freed

    def pages(self) -> list:
        """Every page the trie holds a reference on (sorted)."""
        return sorted(self._by_page)

    def evict_pages(self, pages) -> list:
        """Drop the trie's reference on ``pages`` and on every descendant
        chunk (a child's prefix is unreachable without its parent): the
        refusal path of a codec change. Readers keep a page live until they
        are preempted. Returns the pages whose trie reference was dropped."""
        dropped = []
        for page in pages:
            node = self._by_page.get(int(page))
            if node is None:
                continue
            stack = [node]
            while stack:
                nd = stack.pop()
                stack.extend(nd.children.values())
                if nd.page in self._by_page:
                    dropped.append(nd.page)
                    self._drop(nd)
        if dropped and self.recorder:
            self.recorder.emit("trie_evict", shard=self.shard, pages=len(dropped),
                               reason="forced")
        return dropped

    def drain(self) -> list:
        """Release every trie reference (serve teardown)."""
        pages = list(self._by_page)
        for page in pages:
            node = self._by_page.get(page)
            if node is not None:
                del node.parent.children[node.key]
                del self._by_page[node.page]
                self.alloc.free([node.page], self.OWNER)
        self._root.children.clear()
        return pages


class SharedPageDEDError(RuntimeError):
    """``KVPageArena.change_codec`` found a latched detected-uncorrectable
    word on a page with more than one reader: re-encoding would seal the
    corruption as clean data for every reader at once. ``pages`` names the
    offending pages, so the scheduler can evict and preempt, then retry."""

    def __init__(self, pages, codec: str):
        self.pages = tuple(int(p) for p in pages)
        self.codec = str(codec)
        super().__init__(
            f"codec change to {self.codec!r} refused: latched DED on shared "
            f"pages {list(self.pages)}"
        )


def _payload_to_planes(payload):
    """(N, token_f32) float -> lo/hi (N, token_words) int32 (lo = even,
    hi = odd f32 viewed as words)."""
    u = payload.to(torch.float32).contiguous().view(torch.int32)
    return u[:, 0::2], u[:, 1::2]


def _planes_to_payload(lo, hi):
    """Inverse of ``_payload_to_planes``."""
    return torch.stack([lo, hi], dim=-1).reshape(lo.shape[0], -1).view(torch.float32)


def _commit_tokens(lo, hi, par, payload, row_base, *, token_words: int,
                   codec: str = codes.DEFAULT_CODEC):
    """Encode token payload rows (N, token_f32) and write row r to words
    ``row_base[r]`` .. ``row_base[r] + token_words - 1`` of the planes, in
    place; returns the planes. ``row_base`` (N,) int64 on the planes' device
    is ``page * words_per_page + slot * token_words``."""
    kops.encode_commit(
        payload.to(torch.float32).contiguous(), row_base, token_words, lo, hi, par, codec=codec
    )
    return lo, hi, par


def row_bases(page_ids, slots, geom: KVGeometry) -> np.ndarray:
    """Host int64 word offsets ``page * words_per_page + slot * token_words``."""
    return (
        np.asarray(page_ids, np.int64) * geom.words_per_page
        + np.asarray(slots, np.int64) * geom.token_words
    )


class KVPageArena:
    """The paged KV store: flat ECC planes + rail state + fault model.

    ``n_pages`` real pages plus one scratch row (index ``n_pages``) that
    masked or inactive writes are steered to; the scratch row is never read
    for a request. ``device=None`` is the card. ``env`` is an environment
    scenario (a name or an ``EnvironmentProfile``, as ``scenario.resolve``
    takes); its flux belongs in ``profile``."""

    def __init__(
        self,
        geom: KVGeometry,
        profile: PlatformProfile,
        n_pages: int,
        seed: int = 0,
        ecc: bool = True,
        codec: str = codes.DEFAULT_CODEC,
        device=None,
        mask_fn=None,
        env=None,
    ):
        self.geom = geom
        self.env = scenario.resolve(env)
        self._burst = scenario.active_burst(self.env)
        self.profile = profile
        self.n_pages = int(n_pages)
        self.ecc = bool(ecc)
        self.seed = int(seed)
        self.codec_name = str(codec)
        self.codec = codes.get(self.codec_name)
        self.device = resolve_device(device)
        self.mask_fn = mask_fn
        self.shard = 0  # the mesh shard the arena serves (the reference's default)
        w = geom.words_per_page
        self.n_words = self.n_pages * w  # real (non-scratch) words
        self._total_words = (self.n_pages + 1) * w
        z = lambda dt: torch.zeros(self._total_words, dtype=dt, device=self.device)
        # all-zero data has all-zero check bits under every linear code: the
        # empty arena is clean
        self.lo, self.hi = z(torch.int32), z(torch.int32)
        self.parity = z(self.codec.check_torch_dtype)
        self.voltage = float(profile.v_nom)
        self._interval = 0
        self.faulted = False  # True once any tick() injected a mask
        self.stats = FaultStats()  # cumulative scrub-on-read telemetry

    @property
    def scratch_page(self) -> int:
        return self.n_pages

    def set_voltage(self, v: float) -> None:
        self.voltage = float(v)

    def change_codec(self, codec: str, shared_pages=None) -> None:
        """Re-protect the live arena under another registered code: the
        check plane is re-encoded from the current page contents (one
        encode launch), so faults the old code had not corrected are sealed
        as data. Call it right after an interval scrub; the scheduler does.

        ``shared_pages`` (pages with more than one reader) are scrubbed
        under the old code first, their counters joining ``stats``. If a DED
        stays latched on one of them, the change is refused with
        :class:`SharedPageDEDError`: the code and the check plane stay as
        they were (the scrub's write-back of corrected words stays)."""
        if codec == self.codec_name:
            return
        ids = np.asarray([] if shared_pages is None else list(shared_pages), np.int32)
        if ids.size:
            _, cnt = self.scrub_pages(ids)
            self.stats.accumulate(
                FaultStats.from_counters(
                    cnt.sum(axis=0), words=int(ids.size) * self.geom.words_per_page,
                    shard=self.shard,
                )
            )
            detected = cnt[:, 2]  # the counters' "detected" lane
            if detected.any():
                raise SharedPageDEDError(ids[detected > 0].tolist(), codec)
        self.codec_name = str(codec)
        self.codec = codes.get(self.codec_name)
        self.parity = kops.encode(self.lo, self.hi, codec=self.codec_name)

    def _masks(self, rate: float):
        return obs_profile.call("kv.inject_masks", self._draw_masks, rate)

    def _draw_masks(self, rate: float):
        sigma, n_check = float(self.profile.row_sigma), self.codec.n_check
        kw = {"burst": self._burst} if self._burst is not None else {}
        if self.mask_fn is None:
            out = faultsim.interval_masks(
                self.seed, self._interval, self._total_words, rate, sigma, n_check,
                device=self.device, **kw,
            )
        else:
            out = self.mask_fn(self._interval, self._total_words, rate, sigma, n_check, **kw)
        as_t = lambda a: torch.as_tensor(
            as_words(a) if isinstance(a, np.ndarray) else a, device=self.device
        )
        return tuple(as_t(a) for a in out)

    def tick(self) -> None:
        """Inject one interval's faults at the current rail voltage (a fresh
        draw per interval; no-op inside the guardband). Under an
        environment the rate takes this chip's aging multiplier at the
        interval count, and the masks its burst shape."""
        self._interval += 1
        rate = self.profile.fault_rate(self.voltage)
        if rate <= 0.0:
            return
        rate *= scenario.aging_multiplier(self.shard, self._interval, self.env, self.seed)
        self.faulted = True
        mlo, mhi, mpar = self._masks(rate)
        self.lo ^= mlo
        self.hi ^= mhi
        self.parity ^= mpar
        if not self.ecc:
            # No-ECC baseline: check bits track the faulty data, so the read
            # path passes faults through to attention.
            self.parity = kops.encode(self.lo, self.hi, codec=self.codec_name)

    def _pages(self, page_ids) -> torch.Tensor:
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() > self.n_pages):
            raise IndexError(f"page ids outside [0, {self.n_pages}]")
        return to_device(ids.astype(np.int32), self.device)

    def zero_pages(self, page_ids) -> None:
        """Clear freshly allocated pages (all-zero words are a clean
        codeword), so a previous owner's faults are never charged to the
        next owner."""
        ids = self._pages(page_ids).to(torch.int64)
        if ids.numel() == 0:
            return
        w = self.geom.words_per_page
        for plane in (self.lo, self.hi, self.parity):
            plane.view(self.n_pages + 1, w)[ids] = 0

    def commit_tokens(self, payload, page_ids, slots) -> None:
        """Write one token per row: payload (N, token_f32), page_ids and
        slots (N,) host ints (slot = position within the page). Rows steered
        to the scratch page are don't-cares."""
        base = to_device(row_bases(page_ids, slots, self.geom), self.device)
        obs_profile.call(
            "kv.commit_tokens", _commit_tokens, self.lo, self.hi, self.parity, payload, base,
            token_words=self.geom.token_words, codec=self.codec_name,
        )

    def scrub_pages_async(self, page_ids):
        """Scrub-on-read of ``page_ids`` (any shape, flattened) with the
        write-back committed: (payload (P, page_tokens, token_f32) float32,
        counters (P, 8) int32 on the arena's device). The caller harvests
        the counters when it wants the host to wait for them."""
        ids = self._pages(page_ids)
        payload, cnt = obs_profile.call(
            "kv.paged_gather_scrub", kops.gather_scrub_pages,
            self.lo, self.hi, self.parity, ids, self.geom.words_per_page, codec=self.codec_name,
        )
        return payload.reshape(ids.shape[0], self.geom.page_tokens, self.geom.token_f32), cnt

    def scrub_pages(self, page_ids):
        """Scrub-on-read of ``page_ids``: (payload, counters (P, 8) numpy
        int32)."""
        payload, cnt = self.scrub_pages_async(page_ids)
        return payload, cnt.cpu().numpy()


def arena_from_numpy(arena: KVPageArena, lo, hi, parity) -> KVPageArena:
    """Carry another arena's planes (numpy uint32 lo/hi, a uint8 or uint32
    check plane, e.g. the reference arena's arrays) into ``arena``."""
    for name, a in (("lo", lo), ("hi", hi), ("parity", parity)):
        t = torch.from_numpy(np.array(as_words(np.asarray(a)))).to(arena.device)
        ref = getattr(arena, name)
        assert t.shape == ref.shape and t.dtype == ref.dtype, (name, t.shape, t.dtype)
        setattr(arena, name, t)
    return arena
