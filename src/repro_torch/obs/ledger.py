"""The per-shard load ledger. Counterpart of ``repro/obs/ledger.py``.

``snapshot_local`` is the device half: the ledger rows of the shards
whose state this process holds, ``(n_local, n_metrics)`` f32, reduced
from what ``core.stages.ledger_view`` exposes (every shard in one
process; a rank's own under a crawl group, the reference's shard-local
row); ``snapshot`` gathers every rank's rows in shard order. It only
reads the state, so a crawl with telemetry on follows the same
trajectory as one with it off; the eager step and the chunk take the
same snapshot, so their ledgers are identical too. The session keeps a chunk's rows on the device and copies
them to the host once a chunk.

A dead shard's row is zeroed at the source (multiplied by its
``shard_alive`` flag); the ``alive`` column is the mask the health metrics
average by.

``LedgerBuffer`` is the host half: it accumulates the rows as the session
runs and round-trips through ``train.checkpoint`` (an ``obs/`` directory
beside the crawl state) in the JAX package's format.

Counters come from the cumulative ``CrawlState.stats`` rows, stored as
f32: exact up to 2^24 events per shard per counter. ``cash_mass`` adds by
``kernels.rowsum.tree_sum``'s fixed halving tree (the same bits on the
card and the CPU; XLA's order differs in the last bits).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import frontier as F
from repro_torch.core import stages as ST
from repro_torch.dist import CrawlGroup
from repro_torch.kernels.rowsum import tree_sum
from repro_torch.ordering.policies import ORD_URL0

# the fixed metric columns; per-bucket queue occupancy columns follow
# (``queue_b0``..``queue_b{n_buckets-1}``, named by ledger_metrics(cfg))
LEDGER_BASE: Tuple[str, ...] = (
    "alive",            # 1.0 while this shard lives, 0.0 after a failure
    "frontier_depth",   # queued URLs across the shard's frontier rows
    "fetch_backlog",    # queued URLs beyond one step's fetch budget
    "staging_fill",     # URLs staged for the next dispatch
    "outbox_fill",      # URLs parked in the batched mode's outbox
    "cash_mass",        # ordering cash held locally (slots + URL lane +
                        # in-transit staging and outbox values)
    "fetched",          # cumulative stats counters (per shard) ...
    "fetch_foreign",
    "dispatch_sent",
    "dispatch_recv",
    "coord_dropped",
    "coord_deferred",
    "dispatch",         # 1.0 on records taken after a dispatch step
)


def ledger_metrics(cfg: CrawlConfig) -> Tuple[str, ...]:
    """Metric column names for this config (the bucket count is the
    config's)."""
    return LEDGER_BASE + tuple(
        f"queue_b{b}" for b in range(cfg.n_priority_buckets))


def snapshot(cfg: CrawlConfig, state: ST.CrawlState,
             dispatch: bool = False) -> torch.Tensor:
    """Every shard's ledger row, ``(n_shards, n_metrics)`` f32, on the
    state's device, in shard order; no host sync in one process (under a
    crawl group every rank calls it, and the rows are gathered).
    ``dispatch`` flags the records taken after an exchange step."""
    return CrawlGroup.current().gather(snapshot_local(cfg, state, dispatch))


def snapshot_local(cfg: CrawlConfig, state: ST.CrawlState,
                   dispatch: bool = False) -> torch.Tensor:
    """The ledger rows of the shards this process holds, ``(n_local,
    n_metrics)`` f32, on the state's device; no host sync. The
    reference's ``snapshot_local`` is one shard's row inside its
    ``shard_map``; a process here holds L shards, one row each."""
    view = ST.ledger_view(state)
    stats = view["stats"]
    n = stats.shape[0]
    fr: F.Frontier = view["frontier"]
    depth = fr.valid.view(n, -1).sum(1).to(torch.float32)
    backlog = torch.clamp(depth - float(cfg.fetch_batch), min=0.0)
    os_ = view["order_state"]
    cash = tree_sum(os_[:, 0].reshape(n, -1))
    if os_.shape[1] > ORD_URL0:
        cash = cash + tree_sum(tree_sum(os_[:, ORD_URL0:]).view(n, -1))
    cash = (cash + tree_sum(view["staging_val"])
            + tree_sum(view["outbox_val"]))

    def stat(name):
        return stats[:, ST.SIDX[name]].to(torch.float32)

    cols = [torch.ones_like(depth), depth, backlog,
            view["staging_n"].to(torch.float32),
            view["outbox_n"].to(torch.float32), cash,
            *(stat(s) for s in LEDGER_BASE[6:12]),
            torch.full_like(depth, 1.0 if dispatch else 0.0)]
    occ = F.bucket_occupancy(fr.priority, fr.valid, cfg.n_priority_buckets,
                             groups=n)
    # shard_alive is every shard's: this process's run of it
    alive = CrawlGroup.current().local(view["shard_alive"]).to(torch.float32)
    return torch.cat([torch.stack(cols, dim=1), occ], dim=1) * alive[:, None]


class LedgerBuffer:
    """Host-side accumulator for ledger rows: the session appends one
    ``(n_shards, n_metrics)`` row per step (or a chunk's stacked block)
    and drivers read the whole ``(n_records, n_shards, n_metrics)`` series
    back through :meth:`arrays`."""

    def __init__(self, names: Tuple[str, ...], n_shards: int):
        self.names = tuple(names)
        self.n_shards = int(n_shards)
        self._steps: List[int] = []
        self._rows: List[np.ndarray] = []

    def __len__(self) -> int:
        return len(self._steps)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def append(self, step: int, row) -> None:
        row = np.asarray(row, np.float32)
        if row.shape != (self.n_shards, len(self.names)):
            raise ValueError(f"ledger row of shape {row.shape}, want "
                             f"{(self.n_shards, len(self.names))}")
        self._steps.append(int(step))
        self._rows.append(row)

    def append_block(self, steps, rows) -> None:
        """One chunk's stacked rows: (T, n_shards, n_metrics)."""
        for s, r in zip(steps, np.asarray(rows, np.float32)):
            self.append(s, r)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        steps = np.asarray(self._steps, np.int64)
        rows = (np.stack(self._rows) if self._rows
                else np.zeros((0, self.n_shards, len(self.names)),
                              np.float32))
        return steps, rows

    def load(self, steps, rows) -> None:
        """Replace the contents (checkpoint restore)."""
        self._steps = [int(s) for s in np.asarray(steps)]
        self._rows = [np.asarray(r, np.float32) for r in np.asarray(rows)]

    def clear(self) -> None:
        self._steps, self._rows = [], []

    def tail(self) -> Dict[str, np.ndarray]:
        """The latest row as {metric: (n_shards,)}."""
        if not self._rows:
            return {}
        last = self._rows[-1]
        return {n: last[:, i] for i, n in enumerate(self.names)}
