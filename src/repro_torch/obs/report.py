"""Markdown run-summary renderer for flight-recorder JSONL traces.

    python -m repro_torch.obs.report trace.jsonl [--out SUMMARY.md] [--validate]

Reads an event log written by ``TraceRecorder.to_jsonl`` (or any JSONL of
schema-conforming events), optionally validates every line against the
event schema, and renders the same markdown summary the in-process
``recorder.summary_markdown()`` produces.
"""

from __future__ import annotations

import argparse

from repro_torch.obs import events as events_mod
from repro_torch.obs import export


def render(path, validate: bool = False) -> str:
    events = export.read_jsonl(path)
    if validate:
        events_mod.validate_events(events)
    return export.summary_markdown(events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="JSONL event log path")
    ap.add_argument("--out", default=None, help="write markdown here (default stdout)")
    ap.add_argument(
        "--validate", action="store_true",
        help="validate every event against the schema first",
    )
    args = ap.parse_args(argv)
    md = render(args.trace, validate=args.validate)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
    else:
        print(md, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
