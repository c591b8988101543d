"""repro_torch.obs — the port's observability layer: the per-shard load
ledger (``ledger``), span tracing with Chrome trace export (``trace``),
and the health metrics derived from the ledger (``health``), threaded
through ``CrawlSession``.

Telemetry is off by default (``CrawlConfig.telemetry``); off, the step
path has no hook and runs the same launches and host syncs as without the
layer. ``REPRO_TELEMETRY=1`` turns it on for every session.
"""
from __future__ import annotations

import os

from repro_torch.obs.health import CrawlTelemetry, ServeTelemetry
from repro_torch.obs.ledger import (LEDGER_BASE, LedgerBuffer,
                                    ledger_metrics, snapshot, snapshot_local)
from repro_torch.obs.trace import Event, Tracer, validate_chrome_trace

__all__ = [
    "CrawlTelemetry", "ServeTelemetry", "Event", "Tracer",
    "LEDGER_BASE", "LedgerBuffer", "ledger_metrics", "snapshot",
    "snapshot_local",
    "telemetry_enabled", "validate_chrome_trace",
]


def telemetry_enabled(cfg) -> bool:
    """The config flag or ``REPRO_TELEMETRY=1`` (any value but "" or
    "0"): sessions call this when they are built."""
    if bool(getattr(cfg, "telemetry", False)):
        return True
    return os.environ.get("REPRO_TELEMETRY", "0") not in ("", "0")
