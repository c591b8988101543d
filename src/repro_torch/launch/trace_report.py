"""Crawl-timeline reporter — render an exported trace back into tables.
Port copy of ``repro/launch/trace_report.py``: it reads a trace written by
either package (the file format is the same).

Reads a trace file written by ``--trace-out`` (``launch/crawl.py``,
``launch/serve_search.py``) or ``Tracer.write``, validates it against the
Chrome ``trace_event`` structural schema, and prints:

  * the per-interval shard-load table rebuilt from the embedded ledger
    (``otherData.ledger`` — the file is self-contained, no session needed);
  * the derived health line (load imbalance, frontier growth, comm/page);
  * a span summary (count + total wall per (category, name)).

  PYTHONPATH=src python -m repro_torch.launch.trace_report run.trace.json

The render helpers are shared with the launchers, which print the same
table live at the end of a ``--trace`` run.
"""
from __future__ import annotations

import argparse
import json
from typing import List

import numpy as np


def load_trace(path: str) -> dict:
    """Load a ``.json`` Chrome trace or a ``.jsonl`` event stream into the
    one document shape (``traceEvents`` + optional ``otherData``)."""
    if path.endswith(".jsonl"):
        doc = {"traceEvents": []}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if "otherData" in obj and "ph" not in obj:
                    doc["otherData"] = obj["otherData"]
                else:
                    doc["traceEvents"].append(obj)
        return doc
    with open(path) as f:
        return json.load(f)


def telemetry_from_trace(doc: dict):
    """Rebuild a :class:`~repro_torch.obs.health.CrawlTelemetry` from the trace
    document's embedded ledger; None if the file carries no ledger."""
    from repro_torch.obs.health import CrawlTelemetry
    led = doc.get("otherData", {}).get("ledger")
    if not led:
        return None
    return CrawlTelemetry(
        steps=np.asarray(led["steps"], np.int64),
        rows=np.asarray(led["rows"], np.float32),
        names=tuple(led["names"]),
        interval=int(led["interval"]),
        spans=tuple(doc.get("traceEvents", ())))


def render_ledger_table(tel, *, max_shards: int = 8) -> str:
    """The per-interval shard-load table: one row per dispatch boundary,
    per-shard frontier depth + imbalance + comm counters."""
    pi = tel.per_interval()
    if pi.n_records == 0:
        pi = tel                       # no boundary records: show raw steps
    if pi.n_records == 0:
        return "(empty ledger)"
    ns = pi.n_shards
    shown = min(ns, max_shards)
    depth = pi.col("frontier_depth")
    sent = pi.col("dispatch_sent").sum(axis=1)
    stage = pi.col("staging_fill").sum(axis=1)
    imb = pi.imbalance()
    head = (["step"] + [f"shard{i}" for i in range(shown)]
            + (["..."] if ns > shown else [])
            + ["total", "imb", "staged", "sent(cum)"])
    lines = ["  ".join(f"{h:>9}" for h in head)]
    for r in range(pi.n_records):
        cells = [f"{int(pi.steps[r]):>9}"]
        cells += [f"{int(depth[r, i]):>9}" for i in range(shown)]
        if ns > shown:
            cells.append(f"{'':>9}")
        cells += [f"{int(depth[r].sum()):>9}", f"{imb[r]:>9.2f}",
                  f"{int(stage[r]):>9}", f"{int(sent[r]):>9}"]
        lines.append("  ".join(cells))
    return "\n".join(lines)


def render_spans(events) -> str:
    """Span summary: wall seconds + launch counts per (category, name)."""
    from repro_torch.obs.trace import span_totals
    totals = span_totals(events)
    if not totals:
        return "(no spans)"
    lines = [f"{'category':>10}  {'span':<16} {'count':>6}  {'total':>9}  "
             f"{'mean':>9}"]
    for (cat, name), (n, tot) in sorted(totals.items(),
                                        key=lambda kv: -kv[1][1]):
        lines.append(f"{cat:>10}  {name:<16} {n:>6}  {tot:>8.3f}s  "
                     f"{tot / n * 1e3:>7.2f}ms")
    return "\n".join(lines)


def render_report(tel) -> str:
    """The full text report for one telemetry object (launchers + CLI)."""
    parts = ["== per-interval shard load ==", render_ledger_table(tel),
             "", tel.summary(), "", "== spans ==", render_spans(tel.spans)]
    return "\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render an exported crawl trace (see launch/crawl.py "
                    "--trace-out) as shard-load + span tables.")
    ap.add_argument("trace", help="path to a .trace.json / .jsonl file")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip the trace_event schema check")
    args = ap.parse_args(argv)

    from repro_torch.obs.trace import validate_chrome_trace
    doc = load_trace(args.trace)
    if not args.no_validate:
        errs = validate_chrome_trace(doc)
        if errs:
            print(f"INVALID trace ({len(errs)} violations):")
            for e in errs[:20]:
                print("  -", e)
            return 1
        print(f"valid Chrome trace: {len(doc['traceEvents'])} events")

    tel = telemetry_from_trace(doc)
    if tel is None:
        print("(no embedded ledger — span summary only)")
        print(render_spans(doc.get("traceEvents", ())))
        return 0
    print(render_report(tel))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
