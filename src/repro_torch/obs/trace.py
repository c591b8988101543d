"""Wall-clock span tracing and Chrome ``trace_event`` export. A port copy
of ``repro/obs/trace.py``.

The tracer records what the host can see: spans around each chunk, eager
step, checkpoint and restore (the session waits for the device's result
inside the span, so a span's duration is real work, not an asynchronous
launch's return), instants for the C4 fail and heal and for rebalances,
and counter series sampled from the load ledger at dispatch boundaries.
``Tracer(profiler=True)`` (or ``REPRO_PROFILER_ANNOTATIONS=1``) also
mirrors each host span into a ``torch.profiler.record_function`` range, so
that a ``torch.profiler`` capture labels the device work under it.

Export formats: ``.json``, a Chrome ``trace_event`` document (``X`` spans,
``i`` instants, ``C`` counters, the ledger under ``otherData.ledger``);
``.jsonl``, the same events one JSON object a line.
``validate_chrome_trace`` is the structural schema check.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Event:
    """One trace event, in (a host-side mirror of) trace_event terms."""
    name: str
    cat: str
    ph: str                      # "X" complete | "i" instant | "C" counter
    ts: float                    # seconds since the tracer's origin
    dur: float = 0.0             # seconds ("X" only)
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tid: int = 0


class Tracer:
    """Accumulates :class:`Event` records; cheap enough to leave on (one
    list append per host-visible boundary)."""

    def __init__(self, *, profiler: Optional[bool] = None):
        self.events: List[Event] = []
        self._origin = time.perf_counter()
        if profiler is None:
            profiler = os.environ.get(
                "REPRO_PROFILER_ANNOTATIONS", "0") not in ("", "0")
        self.profiler = bool(profiler)

    def now(self) -> float:
        return time.perf_counter() - self._origin

    @contextmanager
    def span(self, name: str, cat: str = "stage", **args):
        """Record a complete ("X") event around the body. Callers that time
        device work must block on the result inside the span — the span is
        a wall-clock claim, and an async dispatch return is not compute."""
        if self.profiler:
            import torch
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        t0 = self.now()
        try:
            yield self
        finally:
            if self.profiler:
                ann.__exit__(None, None, None)
            self.events.append(Event(name=name, cat=cat, ph="X", ts=t0,
                                     dur=self.now() - t0, args=dict(args)))

    def instant(self, name: str, cat: str = "event", **args) -> None:
        self.events.append(Event(name=name, cat=cat, ph="i", ts=self.now(),
                                 args=dict(args)))

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "ledger") -> None:
        """One counter sample: ``values`` maps series name (e.g. ``shard0``)
        to the sampled value — Chrome renders them as stacked area rows."""
        self.events.append(Event(name=name, cat=cat, ph="C", ts=self.now(),
                                 args={k: float(v) for k, v in
                                       values.items()}))

    # -- export -------------------------------------------------------------

    def chrome_events(self) -> List[Dict[str, Any]]:
        out = []
        for e in self.events:
            ev = {"name": e.name, "cat": e.cat, "ph": e.ph, "pid": 0,
                  "tid": e.tid, "ts": round(e.ts * 1e6, 3)}
            if e.ph == "X":
                ev["dur"] = round(e.dur * 1e6, 3)
            if e.ph == "i":
                ev["s"] = "g"                    # global-scope instant
            if e.args:
                ev["args"] = e.args
            out.append(ev)
        return out

    def to_chrome(self, telemetry=None) -> Dict[str, Any]:
        """The full trace document; ``telemetry`` (a CrawlTelemetry or
        anything with steps/rows/names/interval) embeds the load ledger
        under ``otherData.ledger`` for the timeline reporter."""
        doc: Dict[str, Any] = {"traceEvents": self.chrome_events(),
                               "displayTimeUnit": "ms"}
        if telemetry is not None:
            doc["otherData"] = {"ledger": ledger_payload(telemetry)}
        return doc

    def write(self, path: str, telemetry=None) -> str:
        """Write ``.jsonl`` (one event per line, ledger as a trailing
        ``otherData`` line) or Chrome-trace ``.json`` (anything else)."""
        doc = self.to_chrome(telemetry)
        with open(path, "w") as f:
            if path.endswith(".jsonl"):
                for ev in doc["traceEvents"]:
                    f.write(json.dumps(ev) + "\n")
                if "otherData" in doc:
                    f.write(json.dumps({"otherData": doc["otherData"]}) + "\n")
            else:
                json.dump(doc, f, indent=1)
                f.write("\n")
        return path


def ledger_payload(telemetry) -> Dict[str, Any]:
    """JSON-serializable ledger block (the reporter's table source)."""
    import numpy as np
    return {
        "names": list(telemetry.names),
        "interval": int(telemetry.interval),
        "steps": np.asarray(telemetry.steps).astype(int).tolist(),
        "rows": np.asarray(telemetry.rows, float).round(4).tolist(),
    }


_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def validate_chrome_trace(doc: Any) -> List[str]:
    """Structural trace_event schema check; returns a list of violations
    (empty = valid)."""
    errs = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document must be an object with a traceEvents array"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents must be an array"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        for k in _REQUIRED:
            if k not in ev:
                errs.append(f"event {i} ({ev.get('name')}): missing {k!r}")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "C", "M"):
            errs.append(f"event {i}: unknown phase {ph!r}")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            errs.append(f"event {i} ({ev.get('name')}): X event needs "
                        f"numeric dur")
        if ph == "C" and not isinstance(ev.get("args"), dict):
            errs.append(f"event {i} ({ev.get('name')}): C event needs args")
        if not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"event {i} ({ev.get('name')}): ts must be numeric")
    return errs


def span_totals(events) -> Dict[Tuple[str, str], Tuple[int, float]]:
    """Aggregate spans -> {(cat, name): (count, total seconds)}. Accepts
    :class:`Event` objects or chrome-format dicts."""
    out: Dict[Tuple[str, str], Tuple[int, float]] = {}
    for e in events:
        if isinstance(e, Event):
            ph, key, dur = e.ph, (e.cat, e.name), e.dur
        else:
            ph = e.get("ph")
            key = (e.get("cat", ""), e.get("name", ""))
            dur = float(e.get("dur", 0.0)) * 1e-6
        if ph != "X":
            continue
        n, tot = out.get(key, (0, 0.0))
        out[key] = (n + 1, tot + dur)
    return out
