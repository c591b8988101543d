"""The crawl step composer. Counterpart of ``repro/core/crawler.py``.

``make_crawl_step`` builds the shard-local step: the stage pipeline
(allocate -> fetch_analyze -> extract_stage) and, on exchange steps,
``dispatch_exchange``. ``mark_dead`` simulates a crawl process failing. The
rebalancing half of C4 (``apply_rebalance``) is the next slice of the port.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import classifier as CLS
from repro_torch.core import stages as ST
from repro_torch.core.stages import (CrawlState, FetchReport, NSTAT, SIDX,
                                     STATS, Stage, frontier_view, init_state,
                                     with_frontier)

__all__ = [
    "CrawlState", "FetchReport", "NSTAT", "SIDX", "STATS", "Stage",
    "frontier_view", "with_frontier", "init_state", "make_crawl_step",
    "mark_dead",
]


def make_crawl_step(cfg: CrawlConfig, *, n_shards: int, device,
                    shard: int = 0,
                    classify_accuracy: float = CLS.DEFAULT_ACCURACY,
                    extra_stages: Sequence[Stage] = ()):
    """Build the shard-local step: fn(state, *, dispatch) -> (state,
    FetchReport)."""
    ctx = ST.make_context(cfg, n_shards=n_shards, device=device, shard=shard,
                          classify_accuracy=classify_accuracy)
    pipeline = ST.assemble_pipeline(ctx, extra_stages)

    def local_step(state: CrawlState, *, dispatch: bool
                   ) -> Tuple[CrawlState, FetchReport]:
        carry = None
        for stage in pipeline:
            state, carry, delta = stage(ctx, state, carry)
            state = ST.apply_delta(state, delta)
        if dispatch:
            state, carry, delta = ST.dispatch_exchange(ctx, state, carry)
            state = ST.apply_delta(state, delta)
        state = state._replace(step=state.step + 1)
        return state, FetchReport(
            torch.where(carry.sel, carry.urls, torch.zeros_like(carry.urls)),
            carry.sel)

    return local_step


def mark_dead(state: CrawlState, shard_ids) -> CrawlState:
    """Simulate the failure of one or more crawl processes."""
    alive = state.shard_alive.clone()
    for s in shard_ids:
        alive[s] = False
    return state._replace(shard_alive=alive)
