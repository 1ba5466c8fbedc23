"""Typed trace events for the reliability flight recorder (DESIGN.md §17).

Every event is a flat JSON-serializable dict with a fixed envelope:

    seq         monotone event index (total causal order of the whole run)
    step        deterministic step-clock value (engine decode steps / scrub
                intervals / autotune rounds — never wall-clock)
    kind        one of EVENT_KINDS
    shard       mesh shard id (-1: unsharded / fleet-wide)
    domain      memory domain name or None (events not tied to a rail)
    request_id  serving request id or None

plus the kind's payload fields. The registry below is the schema the CI
smoke validates emitted JSONL against: a kind must be registered, the
envelope must be complete and well-typed, and every required payload field
must be present (extra payload fields are allowed — the schema is a floor,
not a ceiling, so exporters stay forward-compatible).
"""

from __future__ import annotations

ENVELOPE_FIELDS = ("seq", "step", "kind", "shard", "domain", "request_id")

#: kind -> required payload field names (beyond the envelope).
EVENT_KINDS: dict[str, tuple[str, ...]] = {
    # serve lifecycle -------------------------------------------------------
    "serve_begin": ("n_requests", "n_lanes", "scrub_interval"),
    "serve_end": ("steps", "preemptions", "finished"),
    # scheduler -------------------------------------------------------------
    "admit": ("lane", "prompt_len", "shared_tokens"),
    "preempt": ("lane", "pages_freed", "preemptions"),
    "page_grow": ("pages_added", "pages_total"),
    "retire": ("tokens", "latency_steps", "first_token_step", "preemptions"),
    "gauge": ("name", "value"),
    # prefix-sharing trie ---------------------------------------------------
    "prefix_hit": ("tokens", "pages"),
    "trie_insert": ("pages",),
    "trie_evict": ("pages",),
    # speculative decode ----------------------------------------------------
    "spec_block": ("k", "lanes", "emitted", "slots"),
    # rails / ECC -----------------------------------------------------------
    "rail_step": (
        "action", "voltage", "codec",
        "corrected", "detected", "silent", "words", "divergence",
    ),
    "codec_escalate": ("codec_from", "codec_to", "ded_rate", "acc_trip"),
    "canary_trip": ("divergence", "slo"),
    "canary_probe": ("divergence",),
    "kv_scrub": (
        "interval", "voltage", "codec",
        "corrected", "detected", "silent", "words",
    ),
    "kv_codec_change": ("codec",),
    "shared_ded_recovery": ("pages", "preempted"),
    # campaigns -------------------------------------------------------------
    "campaign_point": ("voltage", "codec", "divergence"),
}


class EventSchemaError(ValueError):
    """An emitted event does not satisfy the registered schema."""


def validate_event(ev: dict) -> dict:
    """Validate one event dict against the schema; returns it unchanged.

    Raises EventSchemaError on an unknown kind, a missing/ill-typed
    envelope field, or a missing required payload field.
    """
    for f in ENVELOPE_FIELDS:
        if f not in ev:
            raise EventSchemaError(f"missing envelope field {f!r}: {ev}")
    kind = ev["kind"]
    if kind not in EVENT_KINDS:
        raise EventSchemaError(f"unknown event kind {kind!r}")
    if not isinstance(ev["seq"], int) or not isinstance(ev["step"], int):
        raise EventSchemaError(f"seq/step must be ints: {ev}")
    if not isinstance(ev["shard"], int):
        raise EventSchemaError(f"shard must be an int: {ev}")
    if ev["domain"] is not None and not isinstance(ev["domain"], str):
        raise EventSchemaError(f"domain must be a str or None: {ev}")
    if ev["request_id"] is not None and not isinstance(ev["request_id"], int):
        raise EventSchemaError(f"request_id must be an int or None: {ev}")
    missing = [f for f in EVENT_KINDS[kind] if f not in ev]
    if missing:
        raise EventSchemaError(f"{kind}: missing payload fields {missing}")
    return ev


def validate_events(events) -> int:
    """Validate an iterable of events + the seq total order; returns the
    count (the CI smoke's one-call check)."""
    n = 0
    prev = -1
    for ev in events:
        validate_event(ev)
        if ev["seq"] <= prev:
            raise EventSchemaError(
                f"seq not strictly increasing: {ev['seq']} after {prev}"
            )
        prev = ev["seq"]
        n += 1
    return n
