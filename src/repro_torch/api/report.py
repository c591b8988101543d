"""Typed crawl reports and the host-side metric helpers. Counterpart of
``repro/api/report.py``."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.stages import STATS, FetchReport
from repro_torch.dist import CrawlGroup


def stats_dict(state) -> Dict[str, int]:
    """Sum the per-shard stat counters into one named dict, plus the
    frontier's FIFO rebase events. Under a crawl group every rank calls
    it and gets every shard's sums."""
    per = stats_per_shard(state)
    return {n: int(v.sum()) for n, v in per.items()}


def stats_per_shard(state) -> Dict[str, np.ndarray]:
    """Each counter as an ``(n_shards,)`` int64 vector, every shard's in
    shard order (gathered from every rank under a crawl group)."""
    g = CrawlGroup.current()
    s = g.gather(state.stats).cpu().numpy().astype(np.int64)
    out = {n: s[:, i].copy() for i, n in enumerate(STATS)}
    out["fifo_rebase"] = g.gather(state.f_rebased).cpu().numpy().astype(
        np.int64).reshape(s.shape[0], -1).sum(1)
    return out


def gather_report(rep: FetchReport) -> FetchReport:
    """A step's ((n_local * r, k) leaves) or a chunk's ((steps,
    n_local * r, k)) FetchReport with every rank's rows, in shard order:
    the whole crawl's report on every rank of a crawl group, the report
    itself in one process."""
    g = CrawlGroup.current()
    return FetchReport(g.gather(rep.fetched_urls, dim=-2),
                       g.gather(rep.fetched_mask, dim=-2))


def overlap_metrics(urls: np.ndarray, cfg) -> Dict[str, float]:
    """C1 (URL) and C2 (content) overlap over a fetched-URL trace."""
    from repro_torch.core import webgraph as W
    if len(urls) == 0:
        return dict(url_dup=0.0, content_dup=0.0, fetched=0)
    canon = W.canonical(torch.from_numpy(urls.astype(np.int64)), cfg).numpy()
    return dict(
        fetched=len(urls),
        url_dup=1.0 - len(np.unique(urls)) / len(urls),
        content_dup=1.0 - len(np.unique(canon)) / len(canon),
    )


def harvest(rep: FetchReport) -> Tuple[List[np.ndarray], List[int]]:
    """Unpack a FetchReport to ([fetched urls per step], [count per step]).
    Takes one step's report ((n_slots, k) leaves) or a chunk's stacked
    report ((steps, n_slots, k) leaves). URLs come back as uint32."""
    m = rep.fetched_mask.cpu().numpy()
    u = rep.fetched_urls.cpu().numpy().astype(np.uint32)
    if m.ndim == 2:
        m, u = m[None], u[None]
    return [u[t][m[t]] for t in range(m.shape[0])], \
           [int(mt.sum()) for mt in m]


@dataclasses.dataclass(frozen=True)
class CrawlReport:
    """What one ``CrawlSession.run`` produced (host-side, numpy)."""
    urls: np.ndarray                     # fetched URL ids in crawl order
    per_step: np.ndarray                 # (steps,) pages fetched per step
    stats: Dict[str, int]                # cumulative counters at run end
    seconds: float                       # wall time of the run
    cfg: Any = dataclasses.field(default=None, repr=False, compare=False)
    stats_per_shard: Dict[str, np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)
    telemetry: Any = dataclasses.field(
        default=None, repr=False, compare=False)   # obs.health.CrawlTelemetry
                                                   # (None with telemetry off)
    rebalances: Tuple = dataclasses.field(
        default=(), repr=False, compare=False)     # RebalanceEvents applied
                                                   # during this run

    @functools.cached_property
    def overlap(self) -> Dict[str, float]:
        """C1/C2 metrics over this run's URLs, computed on first access."""
        if self.cfg is None:
            return dict(url_dup=0.0, content_dup=0.0, fetched=0)
        return overlap_metrics(self.urls, self.cfg)

    @functools.cached_property
    def ordering_quality(self) -> Dict[str, float]:
        """Ordering-quality metrics (``ordering/quality.py``): importance-
        weighted coverage of the fetched pages, how front-loaded it was
        (AUC), and hub-page counts. Computed on first access."""
        from repro_torch.ordering.quality import ordering_quality
        if self.cfg is None:
            return {}
        return ordering_quality(self.urls, self.per_step, self.cfg)

    @functools.cached_property
    def comm(self) -> Dict[str, float]:
        """The communication ledger (``coordination/metrics.py``): URLs
        shipped, received, dropped and deferred by the coordination mode,
        and shipped URLs per fetched page (0 under firewall and
        crossover)."""
        from repro_torch.coordination.metrics import comm_ledger
        return comm_ledger(self.stats, self.fetched)

    @property
    def steps(self) -> int:
        return len(self.per_step)

    @property
    def fetched(self) -> int:
        return int(self.per_step.sum())

    @property
    def pages_per_sec(self) -> float:
        return self.fetched / max(self.seconds, 1e-9)

    def summary(self) -> str:
        line = (f"{self.fetched} pages / {self.steps} steps in "
                f"{self.seconds:.2f}s ({self.pages_per_sec:.0f} pages/s)")
        if self.overlap and self.overlap["fetched"]:
            line += (f", url_dup {100 * self.overlap['url_dup']:.2f}%"
                     f", content_dup {100 * self.overlap['content_dup']:.2f}%")
        if self.rebalances:
            moved = sum(len(e.moves) for e in self.rebalances)
            line += (f", {len(self.rebalances)} rebalances "
                     f"({moved} domains migrated)")
        return line
