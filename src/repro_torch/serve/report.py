"""Typed serve reports — the serving side of the paper's Fig. 1 cascade.
Counterpart of ``repro/serve/report.py``.

``ServeReport`` is to :class:`repro_torch.serve.ServeSession` what
``CrawlReport`` is to ``CrawlSession``: the one host-side result object
every driver reads. It carries the embedded crawl report (the feeder's
own metrics survive unchanged) plus the serving observables the subsystem
exists to measure:

  latency p50/p95/p99 — open-loop per-query latency: completion wall time
      minus the arrival's position mapped into its interval's wall window
      (queueing behind the crawl chunk is IN the number — that is the cost
      of sharing the mesh);
  qps               — queries completed per wall second over the whole run;
  freshness lag     — crawl steps between "now" and the newest indexed
      page at each query's serve time (the incremental-update contract:
      bounded by dispatch_interval x index_every);
  recall@k          — overlap with the full-index oracle's top-k (what
      capacity pressure + staleness cost in answer quality);
  index counters    — docs indexed / dropped-at-capacity (``index_full``
      flags a saturated index: add_batch masks instead of overwriting).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.api.report import CrawlReport


def _pct(lat_ms: np.ndarray, q: float) -> float:
    return float(np.percentile(lat_ms, q)) if len(lat_ms) else 0.0


@dataclasses.dataclass(frozen=True)
class ServeReport:
    """What one ``ServeSession.run`` produced (host-side, numpy)."""
    crawl: CrawlReport                   # the feeder's own report
    latency_ms: np.ndarray               # (n_queries,) per served query
    arrival_step: np.ndarray             # (n_queries,) arrival, step units
    lag_steps: np.ndarray                # (n_queries,) freshness lag
    top_urls: np.ndarray                 # (n_queries, k) served answers
    top_scores: np.ndarray               # (n_queries, k)
    k: int
    seconds: float                       # total wall (crawl + serve)
    serve_seconds: float                 # wall spent in the query path
    index: Dict[str, int]                # n_docs / dropped / capacity ...
    recall_at_k: Optional[float] = None  # vs the full-index oracle
    cfg: Any = dataclasses.field(default=None, repr=False, compare=False)
    telemetry: Any = dataclasses.field(
        default=None, repr=False, compare=False)   # obs.health.ServeTelemetry
                                                   # (None with telemetry off)

    # -- latency / throughput ----------------------------------------------

    @property
    def n_queries(self) -> int:
        return len(self.latency_ms)

    @property
    def p50_ms(self) -> float:
        return _pct(self.latency_ms, 50)

    @property
    def p95_ms(self) -> float:
        return _pct(self.latency_ms, 95)

    @property
    def p99_ms(self) -> float:
        return _pct(self.latency_ms, 99)

    @property
    def qps(self) -> float:
        return self.n_queries / max(self.seconds, 1e-9)

    @property
    def freshness_lag(self) -> float:
        """Mean lag (crawl steps) between serve time and the index."""
        return float(self.lag_steps.mean()) if len(self.lag_steps) else 0.0

    @property
    def max_lag(self) -> int:
        return int(self.lag_steps.max()) if len(self.lag_steps) else 0

    @property
    def index_full(self) -> bool:
        return bool(self.index.get("index_dropped", 0) > 0)

    def metrics(self) -> Dict[str, float]:
        """Flat dict for benchmark persistence (BENCH_serve.json)."""
        out = dict(n_queries=self.n_queries, qps=round(self.qps, 2),
                   p50_ms=round(self.p50_ms, 3), p95_ms=round(self.p95_ms, 3),
                   p99_ms=round(self.p99_ms, 3),
                   freshness_lag_steps=round(self.freshness_lag, 2),
                   max_lag_steps=self.max_lag,
                   pages_per_sec=round(self.crawl.pages_per_sec, 1),
                   fetched=self.crawl.fetched,
                   index_docs=int(self.index.get("index_docs", 0)),
                   index_dropped=int(self.index.get("index_dropped", 0)),
                   serve_seconds=round(self.serve_seconds, 3))
        if self.recall_at_k is not None:
            out[f"recall_at_{self.k}"] = round(self.recall_at_k, 4)
        if self.telemetry is not None:
            tel = self.telemetry.crawl.metrics()
            out["load_imbalance_mean"] = tel.get("load_imbalance_mean", 0.0)
            out["load_imbalance_max"] = tel.get("load_imbalance_max", 0.0)
        return out

    def summary(self) -> str:
        line = (f"{self.n_queries} queries @ {self.qps:.1f} qps | latency "
                f"p50 {self.p50_ms:.1f}ms p95 {self.p95_ms:.1f}ms "
                f"p99 {self.p99_ms:.1f}ms | freshness lag "
                f"{self.freshness_lag:.1f} steps (max {self.max_lag})")
        if self.recall_at_k is not None:
            line += f" | recall@{self.k} {self.recall_at_k:.2f}"
        line += (f" | index {self.index.get('index_docs', 0)} docs"
                 + (f" ({self.index.get('index_dropped', 0)} dropped — FULL)"
                    if self.index_full else ""))
        line += f"\ncrawl: {self.crawl.summary()}"
        return line
