"""The crawl step composer. Counterpart of ``repro/core/crawler.py``.

``make_crawl_step`` builds the step of the process's state, every shard
it holds at once: the stage pipeline (allocate -> fetch_analyze ->
extract_stage) and, on exchange steps, ``dispatch_exchange``, batched
along the leading shard axis where the JAX package runs one shard_mapped
program a device. Under a crawl group (``repro_torch.dist.CrawlGroup``)
each rank builds the same step over its own shards, and the dispatch
exchanges through the group: the JAX package's shard_map over W cards.
``score_fn``, ``stages`` and ``dispatch_stage`` thread through as in the
JAX package. ``make_spmd_crawler`` is the counterpart of the JAX
package's entry of the same name. ``mark_dead`` simulates a crawl
process failing, and ``apply_rebalance`` migrates rows after a remap (the
C4 heal, ``train/fault.heal_crawler``, and the load-driven rebalance),
across ranks under a crawl group.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import classifier as CLS
from repro_torch.core import partitioner as PT
from repro_torch.core import stages as ST
from repro_torch.core.stages import (CrawlState, FetchReport, NSTAT, SIDX,
                                     STATS, Stage, frontier_view, init_state,
                                     with_frontier)
from repro_torch.device import resolve_device
from repro_torch.dist import CrawlGroup
from repro_torch.kernels.rowsum import row_sum
from repro_torch.ordering.policies import ORD_WIDTH

__all__ = [
    "CrawlState", "FetchReport", "NSTAT", "SIDX", "STATS", "Stage",
    "frontier_view", "with_frontier", "init_state", "make_crawl_step",
    "make_spmd_crawler", "mark_dead", "apply_rebalance", "domain_map",
]


def make_crawl_step(cfg: CrawlConfig, *, n_shards: int, device,
                    score_fn: Optional[Callable] = None,
                    classify_accuracy: float = CLS.DEFAULT_ACCURACY,
                    stages: Optional[Sequence[Stage]] = None,
                    extra_stages: Sequence[Stage] = (),
                    dispatch_stage: Stage = ST.dispatch_exchange):
    """Build the step of this process's shards of ``n_shards`` (all of
    them without a crawl group): fn(state, *, dispatch) -> (state,
    FetchReport), the report of the process's rows.

    ``score_fn`` (stateless ``(urls, cfg)``) overrides the ordering
    registry's scorer; by default ``cfg.ordering`` decides.
    ``extra_stages`` slot scenario stages into the assembled pipeline by
    their ``placement``; ``stages`` replaces the WHOLE per-step pipeline
    as given (its first stage must create the StepCarry, as
    ``stages.allocate`` does, and a stateful ordering's update stage must
    be included by hand). ``dispatch_stage`` runs only on exchange
    steps."""
    ctx = ST.make_context(cfg, n_shards=n_shards, device=device,
                          score_fn=score_fn,
                          classify_accuracy=classify_accuracy)
    if stages is None:
        pipeline = ST.assemble_pipeline(ctx, extra_stages)
    else:
        if extra_stages:
            raise ValueError("pass either stages= or extra_stages=, not "
                             "both")
        pipeline = tuple(stages)
    if not pipeline:
        raise ValueError("the crawl pipeline needs at least one stage")

    def step(state: CrawlState, *, dispatch: bool
             ) -> Tuple[CrawlState, FetchReport]:
        carry = None
        for stage in pipeline:
            state, carry, delta = stage(ctx, state, carry)
            state = ST.apply_delta(state, delta)
        if dispatch:
            state, carry, delta = dispatch_stage(ctx, state, carry)
            state = ST.apply_delta(state, delta)
        state = state._replace(step=state.step + 1)
        return state, FetchReport(
            torch.where(carry.sel, carry.urls, torch.zeros_like(carry.urls)),
            carry.sel)

    return step


def make_spmd_crawler(cfg: CrawlConfig, *, n_shards: int, device=None,
                      **kw):
    """The JAX package's shard_mapped crawler over ``n_shards`` shards:
    batched on one device, or, under a crawl group, this rank's share of
    them on its card, the group passed to the stages through their
    context. Returns (init_fn, step_fetch, step_dispatch), each step a
    fn(state) -> (state, FetchReport) of the rank's rows."""
    dev = resolve_device(device)
    step = make_crawl_step(cfg, n_shards=n_shards, device=dev, **kw)
    return (partial(init_state, cfg, n_shards, dev),
            partial(step, dispatch=False), partial(step, dispatch=True))


def mark_dead(state: CrawlState, shard_ids) -> CrawlState:
    """Simulate the failure of one or more crawl processes."""
    alive = state.shard_alive.clone()
    for s in shard_ids:
        alive[s] = False
    return state._replace(shard_alive=alive)


# the row-indexed CrawlState leaves a remap migrates (leading axis = slot)
MIGRATED_ROWS = ("f_url", "f_pri", "f_valid", "f_arrival", "f_dropped",
                 "f_inserted", "f_rebased", "bloom_bits", "order_state")


def domain_map(state: CrawlState) -> PT.DomainMap:
    """The state's whole domain map on every rank: ``slot_domain`` is
    split by rank (``state_specs``) and gathered here; the other two
    maps are replicated."""
    return PT.DomainMap(state.slot_of_domain,
                        CrawlGroup.current().gather(state.slot_domain),
                        state.shard_alive)


def apply_rebalance(state: CrawlState, cfg: CrawlConfig,
                    new_dm: PT.DomainMap) -> CrawlState:
    """Migrate frontier, Bloom and ordering rows to their new slots after a
    remap (a C4 heal moves dead -> live, an elastic move live -> live):
    the reference's gather over the slot axis, each slot pulling the row
    of the slot its domain used to occupy (``PT.source_slots``). The
    migrated leaves are moved IN PLACE by ``CrawlGroup.move_rows``, across
    ranks under a crawl group; no whole copy of a leaf is made. ``new_dm``
    is the whole map, the same on every rank (checked).

    Cash stays exact: the gather leaves a stale copy of each moved row at
    its old slot, whose ordering state is scrubbed; a row the gather
    overwrites (a displaced row) refunds its cash into the incoming row's
    slot cash; a domain merged into an occupied slot (no free slot
    anywhere) refunds its cash into the sharing slot, on the rank that
    owns it, in global slot order; and a vacated row on a live shard is
    cleared, so that no live shard crawls a twin queue."""
    group = CrawlGroup.current()
    group.check_replicated(new_dm, "apply_rebalance")
    old_dm = domain_map(state)
    n_slots = old_dm.domain_of_slot.shape[0]
    n_shards = new_dm.shard_alive.shape[0]
    dev = state.order_state.device
    slots = torch.arange(n_slots, device=dev)
    old_dom = old_dm.domain_of_slot.to(torch.int64)
    new_dom = new_dm.domain_of_slot.to(torch.int64)
    tgt = new_dm.slot_of_domain.to(torch.int64)[torch.clamp(old_dom, min=0)]
    dup = (new_dom < 0) & (old_dom >= 0) & (tgt != slots)
    src = PT.source_slots(old_dm, new_dm)
    # the cash a row held: slot cash plus its url lane (row_sum: one order
    # on every device), read before any row moves
    old_os = state.order_state
    held = old_os[:, 0] + row_sum(old_os[:, ORD_WIDTH:])
    zero = torch.zeros_like(held)
    n_local, shard0 = group.split(n_shards)
    per = n_slots // n_shards
    first, n_rows = shard0 * per, n_local * per
    mine = slice(first, first + n_rows)            # this rank's slots
    displaced = src[mine] != slots[mine]
    # a merged row's cash, every rank's as bits, goes to the rank of its
    # target slot
    held_all = group.gather(held)
    group.move_rows({k: getattr(state, k) for k in MIGRATED_ROWS}, src)
    os_ = state.order_state.masked_fill_(dup[mine][:, None], 0.0)
    col = os_[:, 0] + torch.where(displaced, held, zero)
    merged = dup & (new_dom[tgt] != old_dom) & (tgt >= first) & (
        tgt < first + n_rows)
    ST.add_to_rows(col, torch.where(merged, tgt - first, 0),
                   torch.where(merged, held_all, torch.zeros_like(held_all)),
                   merged, 1)
    os_[:, 0] = col
    vacated_live = (dup & new_dm.shard_alive[
        PT.shard_of_slot(slots, n_slots, n_shards)])[mine]
    for k in MIGRATED_ROWS:
        if k != "order_state":
            a = getattr(state, k)
            a.masked_fill_(vacated_live.reshape((-1,) + (1,) * (a.dim() - 1)),
                           0)
    return state._replace(
        slot_domain=group.local(new_dm.domain_of_slot, n_shards),
        slot_of_domain=new_dm.slot_of_domain, shard_alive=new_dm.shard_alive)
