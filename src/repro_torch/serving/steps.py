"""Serving step functions: prefill, one greedy decode step, and the
paged-cache lane helpers for continuous batching.

``make_paged_helpers`` builds the glue between the dense per-lane decode
cache and the ECC page arena (core/kvpages.py): extract tokens' K/V
payload, load a prefilled batch cache into a lane, refresh lane caches from
scrubbed page payloads, and the decode blocks. The payload layout (per
token: for each attention period position, K then V, each (groups,
kv_heads, head_dim) C-order) is defined only here; extract and refresh are
exact inverses. Caches and arena planes are updated in place; the helpers
return them all the same, so call sites read as the reference's. The
prefill, decode-block and chunk-prefill dispatches go through the opt-in
dispatch profiler (``obs.profile.call``) under the reference's names.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core.kvpages import KVGeometry, _commit_tokens
from repro_torch.models import lm
from repro_torch.models.base import ModelConfig
from repro_torch.obs import profile as obs_profile


def _profiled(name: str, fn):
    """Route a dispatch through the opt-in profiler (one ``is None`` check
    on top of the call when no profiler is enabled)."""
    if fn is None:
        return None

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return obs_profile.call(name, fn, *args, **kwargs)

    return wrapped


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, tokens, cache, img=None) -> (next tokens (B,),
    an audio config's (B, K); cache). A vlm prefill takes its image
    embeddings ``img`` (B, T, D)."""
    def prefill_step(params, tokens, cache, img=None):
        logits, cache = lm.prefill(params, tokens, cfg, cache, img=img)
        return torch.argmax(logits, dim=-1), cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, tokens, cache, pos, img=None) -> (next tokens
    (B, 1), an audio config's (B, K, 1); cache): one greedy decode step
    (a vlm reads its image K/V from the cache)."""
    def serve_step(params, tokens, cache, pos, img=None):
        logits, cache = lm.decode_step(params, tokens, cfg, cache, pos, img=img)
        return torch.argmax(logits, dim=-1)[..., None], cache

    return serve_step


def _extract_tokens(cache, idx, *, geom: KVGeometry):
    """Per-lane token payload: cache + (L,) positions -> (L, token_f32)."""
    lanes = torch.arange(idx.shape[0], device=idx.device)
    parts = []
    for j in geom.attn_positions:
        for name in ("k", "v"):
            c = cache[f"p{j}"][name]  # (g, L, S, H, D)
            sel = c[:, lanes, idx]  # (g, L, H, D)
            parts.append(sel.transpose(0, 1).reshape(idx.shape[0], -1))
    return torch.cat(parts, dim=1).to(torch.float32)


def _extract_span(cachem, *, start: int, stop: int, geom: KVGeometry):
    """Window payload: batch-of-m cache -> (m, stop-start, token_f32) for
    cache positions start..stop-1."""
    parts = []
    for j in geom.attn_positions:
        for name in ("k", "v"):
            c = cachem[f"p{j}"][name]  # (g, m, S, H, D)
            sel = c[:, :, start:stop].permute(1, 2, 0, 3, 4)  # (m, span, g, H, D)
            parts.append(sel.reshape(c.shape[1], stop - start, -1))
    return torch.cat(parts, dim=2).to(torch.float32)


def _extract_range(cachem, *, s0: int, geom: KVGeometry):
    """Prompt payload: batch-of-m cache -> (m, s0, token_f32)."""
    return _extract_span(cachem, start=0, stop=s0, geom=geom)


def _refresh_cache(cache, payload, n_tok, *, geom: KVGeometry):
    """Scatter scrubbed page payloads back into the lane caches, in place.

    payload: (L, T, token_f32) tokens in position order (T beyond the cache
    depth is cut); n_tok: (L,) valid-token counts, positions >= n_tok keep
    their cache bits."""
    length, t_total, _ = payload.shape
    off = 0
    for j in geom.attn_positions:
        for name in ("k", "v"):
            c = cache[f"p{j}"][name]  # (g, L, S, H, D)
            g, _, s, h, d = c.shape
            t = min(t_total, s)
            sz = g * h * d
            part = payload[:, :t, off : off + sz].reshape(length, t, g, h, d)
            part = part.permute(2, 0, 1, 3, 4).to(c.dtype)  # (g, L, t, H, D)
            valid = torch.arange(t, device=c.device)[None, :] < n_tok[:, None]
            c[:, :, :t] = torch.where(valid[None, :, :, None, None], part, c[:, :, :t])
            off += sz
    return cache


def _load_lane(cache, cachem, src_row: int, lane: int):
    """Copy row ``src_row`` of a prefilled batch-of-m cache into ``lane``."""
    for key, sub in cache.items():
        for name, c in sub.items():
            c[:, lane] = cachem[key][name][:, src_row].to(c.dtype)
    return cache


def _bound(max_pos: int | None, n: int) -> int | None:
    """The attention's key bound for n tokens from positions <= max_pos."""
    return None if max_pos is None else max_pos + n


def _multistep(params, tok, cache, lo, hi, par, pos0, row_base, *, cfg, geom, codec,
               max_pos: int | None = None):
    """Decode ``k`` tokens per lane: a loop of k x (decode, extract the
    written token's K/V, commit it to the page arena). ``row_base`` (k, L)
    int64 holds each step's arena word offsets (inactive lanes point at the
    scratch page); ``max_pos``, where given, is max(pos0) on the host.
    Returns (tokens (k, L), cache, lo, hi, par)."""
    toks, pos = [], pos0
    for step in range(row_base.shape[0]):
        logits, cache = lm.decode_step(params, tok, cfg, cache, pos, _bound(max_pos, step + 1))
        tok = torch.argmax(logits, dim=-1)[:, None]
        payload = _extract_tokens(cache, pos, geom=geom)
        lo, hi, par = _commit_tokens(
            lo, hi, par, payload, row_base[step], token_words=geom.token_words, codec=codec
        )
        toks.append(tok[:, 0])
        pos = pos + 1
    return torch.stack(toks), cache, lo, hi, par


def _chunk_prefill(params, tokens, cache, pos0, *, cfg, max_pos: int | None = None):
    """Chunked prefill of ``tokens`` (m, s) at per-lane cache position
    ``pos0`` (m,) (max(pos0) = ``max_pos`` on the host, where given): the
    prefix-sharing admission path. Returns (next_tok (m,), cache)."""
    logits, cache = lm.chunk_step(params, tokens, cfg, cache, pos0,
                                  _bound(max_pos, tokens.shape[1]))
    return torch.argmax(logits, dim=-1), cache


def _spec_multistep(params, dparams, tok, cache, dcache, lo, hi, par, pos0, row_base,
                    scratch_base, *, cfg, dcfg, geom, codec, k, max_pos: int | None = None):
    """Draft k-1 tokens with the draft model, verify all k positions with the
    target model in one chunk forward, commit pages only for accepted tokens.

    tok (L, 1) current tokens at positions pos0 (L,); row_base (k, L) the
    arena word offsets of positions pos0 .. pos0 + k - 1; ``scratch_base``
    (k, L) the same slots' offsets on the scratch page, where rejected rows
    are steered; ``max_pos``, where given, is max(pos0) on the host. Greedy
    acceptance: draft d_{i+1} is accepted iff it equals the target's greedy
    token after t0, d1..d_i, and n_emit = 1 + the accepted prefix, so the
    emitted tokens are exactly greedy decode's. Returns (greedy (L, k),
    n_emit (L,), cache, dcache, lo, hi, par)."""
    length = tok.shape[0]
    if k > 1:
        # k draft steps, not k-1: the k-th writes d_{k-1}'s K/V into the
        # draft cache, so a fully accepted block leaves no hole there.
        t, p, drafts = tok, pos0, []
        for i in range(k):
            logits, dcache = lm.decode_step(dparams, t, dcfg, dcache, p, _bound(max_pos, i + 1))
            t = torch.argmax(logits, dim=-1)[:, None]
            drafts.append(t[:, 0])
            p = p + 1
        tokens_v = torch.cat([tok, torch.stack(drafts[:-1], dim=1)], dim=1)  # (L, k)
    else:
        tokens_v = tok
    full, cache = lm.chunk_logits(params, tokens_v, cfg, cache, pos0, _bound(max_pos, k))
    greedy = torch.argmax(full, dim=-1)  # (L, k)
    if k > 1:
        match = (tokens_v[:, 1:] == greedy[:, :-1]).to(torch.int64)
        n_emit = 1 + torch.cumprod(match, dim=1).sum(dim=1)
    else:
        n_emit = torch.ones(length, dtype=torch.int64, device=tok.device)
    payloads = torch.stack([_extract_tokens(cache, pos0 + i, geom=geom) for i in range(k)])
    accept = torch.arange(k, device=tok.device)[:, None] < n_emit[None, :]
    base = torch.where(accept, row_base, scratch_base)
    lo, hi, par = _commit_tokens(
        lo, hi, par, payloads.reshape(k * length, -1), base.reshape(-1),
        token_words=geom.token_words, codec=codec,
    )
    return greedy, n_emit, cache, dcache, lo, hi, par


@runtime_checkable
class DecodeBlockHelpers(Protocol):
    """The decode-block helper contract the continuous-batching scheduler
    consumes. ``make_paged_helpers`` is the canonical producer; anything
    item-accessible with these keys satisfies it."""

    def __getitem__(self, name: str) -> Callable: ...


@dataclasses.dataclass(frozen=True)
class PagedHelpers:
    """Continuous-batching helpers sharing one payload layout; attribute and
    ``helpers["name"]`` access both work.

      prefill(params, tokens (m,s), cachem)       -> (next_tok (m,), cachem)
      multistep(params, tok, cache, lo, hi, par,
                pos (L,), row_base (k,L), max_pos=) -> (toks (k,L), cache, planes)
      extract_range(cachem, s0=s)                 -> (m, s, token_f32) payload
      extract_span(cachem, start=a, stop=b)       -> (m, b-a, token_f32)
      load_lane(cache, cachem, src_row, lane)     -> cache
      refresh(cache, payload (L,T,F), n_tok (L,)) -> cache
      chunk(params, tokens (m,s), cachem, pos0, max_pos=)
                                                  -> (next_tok (m,), cachem)
      spec_multistep(params, dparams, tok, cache, dcache, lo, hi, par,
                pos (L,), row_base (k,L), scratch_base (k,L), k=, max_pos=)
                -> (greedy (L,k), n_emit (L,), cache, dcache, planes)

    Where the reference passes (page_ids, slots) tables, the port passes the
    arena word offsets they name (``kvpages.row_bases``), on the device.
    ``max_pos`` (optional) is the largest position on the host; it bounds
    the keys the attention reads without changing any result."""

    codec: str
    prefill: Callable
    multistep: Callable
    extract_range: Callable
    extract_span: Callable
    load_lane: Callable
    refresh: Callable
    chunk: Callable
    spec_multistep: Optional[Callable] = None

    def __getitem__(self, name: str) -> Callable:
        fn = getattr(self, name)
        if fn is None:
            raise KeyError(name)
        return fn

    def get(self, name: str, default: Any = None) -> Any:
        return getattr(self, name, default) or default


@runtime_checkable
class HelpersFactory(Protocol):
    """codec name -> decode-block helpers, called by the scheduler when the
    kv rail's escalation changes the arena's codec mid-serve."""

    def __call__(self, codec: str) -> DecodeBlockHelpers: ...


def make_paged_helpers(cfg: ModelConfig, geom: KVGeometry, codec: str = "secded72",
                       draft_cfg: ModelConfig | None = None) -> PagedHelpers:
    """The :class:`PagedHelpers` of one (config, geometry, codec);
    ``draft_cfg`` enables ``spec_multistep``."""
    spec = None
    if draft_cfg is not None:
        spec = _profiled(
            "decode.spec_multistep",
            functools.partial(_spec_multistep, cfg=cfg, dcfg=draft_cfg, geom=geom, codec=codec),
        )
    return PagedHelpers(
        codec=codec,
        prefill=_profiled("decode.prefill", make_prefill_step(cfg)),
        multistep=_profiled(
            "decode.multistep", functools.partial(_multistep, cfg=cfg, geom=geom, codec=codec)
        ),
        extract_range=functools.partial(_extract_range, geom=geom),
        extract_span=functools.partial(_extract_span, geom=geom),
        load_lane=_load_lane,
        refresh=functools.partial(_refresh_cache, geom=geom),
        chunk=_profiled("decode.chunk_prefill", functools.partial(_chunk_prefill, cfg=cfg)),
        spec_multistep=spec,
    )
