"""Derived skew and health metrics over the load ledger. A port copy of
``repro/obs/health.py`` (numpy).

``CrawlTelemetry`` is what ``CrawlReport.telemetry`` carries: the raw
``(n_records, n_shards, n_metrics)`` ledger window and the span trace,
with the derived series the load-driven rebalance decides on:

  * load imbalance factor — per record, max over live shards / mean over
    live shards of a load metric (frontier depth by default); 1.0 is a
    balanced crawl;
  * frontier growth rate — d(total frontier depth)/d(step);
  * comm-per-page trend — cumulative URLs shipped per fetched page.

``ServeTelemetry`` wraps a crawl telemetry with the serving side's
freshness lag. Both give ``.metrics()`` flat dicts.

A dead shard's ledger lane is zeroed at the source (``obs/ledger.py``) and
the ``alive`` column is the mask: every statistic averages over the live
shards only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CrawlTelemetry:
    """One run's ledger window + spans (host-side, numpy)."""
    steps: np.ndarray              # (n_records,) post-step counter values
    rows: np.ndarray               # (n_records, n_shards, n_metrics) f32
    names: Tuple[str, ...]         # metric column names (ledger_metrics)
    interval: int                  # cfg.dispatch_interval
    spans: Tuple = ()              # obs.trace.Event records (whole session)

    # -- raw access ---------------------------------------------------------

    @property
    def n_records(self) -> int:
        return len(self.steps)

    @property
    def n_shards(self) -> int:
        return self.rows.shape[1] if self.rows.ndim == 3 else 0

    def col(self, name: str) -> np.ndarray:
        """One metric as (n_records, n_shards)."""
        return self.rows[:, :, self.names.index(name)]

    def per_interval(self) -> "CrawlTelemetry":
        """The dispatch-boundary records only — the
        ``(n_intervals, n_shards, n_metrics)`` view of the time-series.

        Boundaries come from the ledger's ``dispatch`` column, written by
        the snapshot as the exchange step actually ran — so the selection
        stays correct for a session restored mid-interval or into a changed
        ``dispatch_interval``, where a ``steps % interval == 0`` mask picks
        non-boundary records (regression pinned in tests/test_obs.py).
        Ledgers predating the column (old trace files) fall back to the
        modulo mask."""
        if "dispatch" in self.names:
            # any live shard flags the record (dead lanes are zeroed)
            mask = self.col("dispatch").max(axis=1, initial=0.0) > 0.0
        else:
            mask = (self.steps % max(self.interval, 1)) == 0
        return dataclasses.replace(self, steps=self.steps[mask],
                                   rows=self.rows[mask])

    # -- derived series -----------------------------------------------------

    def alive_mask(self) -> np.ndarray:
        return self.col("alive") > 0.0

    def imbalance(self, metric: str = "frontier_depth") -> np.ndarray:
        """(n_records,) load imbalance factor: max/mean over live shards.
        1.0 = balanced; records with no live shard or zero mean load
        report 1.0 (nothing to balance)."""
        load = self.col(metric)
        alive = self.alive_mask()
        n_live = np.maximum(alive.sum(axis=1), 1)
        mean = load.sum(axis=1) / n_live
        peak = np.where(alive, load, 0.0).max(axis=1) if load.size else \
            np.zeros(0)
        return np.where(mean > 0, peak / np.maximum(mean, 1e-9), 1.0)

    def frontier_growth(self) -> np.ndarray:
        """(n_records-1,) d(total frontier depth)/d(step) between records."""
        depth = self.col("frontier_depth").sum(axis=1)
        dstep = np.maximum(np.diff(self.steps.astype(np.float64)), 1.0)
        return np.diff(depth) / dstep

    def comm_per_page(self) -> np.ndarray:
        """(n_records,) cumulative shipped-URLs-per-fetched-page series."""
        sent = self.col("dispatch_sent").sum(axis=1)
        fetched = self.col("fetched").sum(axis=1)
        return sent / np.maximum(fetched, 1.0)

    # -- flat metrics -------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        if self.n_records == 0:
            return dict(n_records=0)
        imb = self.imbalance()
        growth = self.frontier_growth()
        cpp = self.comm_per_page()
        out = dict(
            n_records=self.n_records,
            n_shards=self.n_shards,
            load_imbalance_mean=round(float(imb.mean()), 4),
            load_imbalance_max=round(float(imb.max()), 4),
            frontier_final=int(self.col("frontier_depth")[-1].sum()),
            frontier_growth_per_step=(round(float(growth.mean()), 3)
                                      if len(growth) else 0.0),
            comm_per_page_final=round(float(cpp[-1]), 4),
            comm_per_page_trend=round(float(cpp[-1] - cpp[0]), 4),
            outbox_peak=int(self.col("outbox_fill").sum(axis=1).max()),
        )
        from repro_torch.obs.trace import span_totals
        for (cat, name), (n, tot) in sorted(span_totals(self.spans).items()):
            out[f"wall_{cat}_{name}_s"] = round(tot, 4)
            out[f"n_{cat}_{name}"] = n
        return out

    def summary(self) -> str:
        m = self.metrics()
        if not m.get("n_records"):
            return "telemetry: no ledger records"
        return (f"telemetry: {m['n_records']} records x {m['n_shards']} "
                f"shards | imbalance mean {m['load_imbalance_mean']:.2f} "
                f"max {m['load_imbalance_max']:.2f} | frontier "
                f"{m['frontier_final']} ({m['frontier_growth_per_step']:+.1f}"
                f"/step) | comm/page {m['comm_per_page_final']:.2f} "
                f"({m['comm_per_page_trend']:+.2f} trend)")


@dataclasses.dataclass(frozen=True)
class ServeTelemetry:
    """Serving-side telemetry: the crawl ledger + the freshness-lag series
    (crawl steps between serve time and the newest indexed page)."""
    crawl: CrawlTelemetry
    lag_steps: np.ndarray          # (n_queries,)
    latency_ms: np.ndarray         # (n_queries,)

    def metrics(self) -> Dict[str, float]:
        out = {f"crawl_{k}": v for k, v in self.crawl.metrics().items()}
        if len(self.lag_steps):
            out["freshness_lag_mean"] = round(float(self.lag_steps.mean()), 2)
            out["freshness_lag_max"] = int(self.lag_steps.max())
        out["n_queries"] = len(self.latency_ms)
        return out

    def summary(self) -> str:
        lag = (f"{float(self.lag_steps.mean()):.1f}"
               if len(self.lag_steps) else "-")
        return (self.crawl.summary()
                + f" | freshness lag {lag} steps over "
                  f"{len(self.latency_ms)} queries")
