"""The four built-in coordination modes. Counterpart of
``repro/coordination/policies.py``.

Each ``plan`` assigns every item of every shard's candidate pool exactly
one fate (ship / keep / defer / drop, or a refund when none applies). The
item tensors are (n_local, P), a row for each shard the process holds
(every shard in one process, a rank's own under a crawl group), and
``shard`` is each item's sending shard as a global id, (n_local, 1); the
policy's flags decide which machinery the dispatch stage runs at all.
Only ``exchange`` and ``batched`` communicate.
"""
from __future__ import annotations

import torch

from repro_torch.coordination.registry import (CoordinationPolicy,
                                               DispatchPlan,
                                               register_coordination)


def _exchange_plan(ctx, state, shard, u, src, val, dest, staged, valid):
    """Ship everything staged to its predicted owner — the paper's C5
    dispatcher (own-shard URLs go through the exchange too)."""
    z = torch.zeros_like(valid)
    return DispatchPlan(ship=valid, keep=z, defer=z, drop=z, foreign=z)


def _firewall_plan(ctx, state, shard, u, src, val, dest, staged, valid):
    """Keep own-partition URLs, drop foreign ones: no communication. A
    dropped URL's value refunds to its source page's row (local: the page
    was fetched here), so the mode loses coverage, never cash."""
    own = dest == shard
    z = torch.zeros_like(valid)
    return DispatchPlan(ship=z, keep=valid & own, defer=z,
                        drop=valid & ~own, foreign=z)


def _crossover_plan(ctx, state, shard, u, src, val, dest, staged, valid):
    """Keep everything, communicate nothing. Foreign URLs are flagged so
    the dispatch stage queues them in a hashed local row at the lowest
    priority bucket: fetched once the local frontier runs dry, and maybe
    by several shards (the mode's C1/C2 overlap)."""
    z = torch.zeros_like(valid)
    return DispatchPlan(ship=z, keep=valid, defer=z, drop=z,
                        foreign=valid & (dest != shard))


def _batched_plan(ctx, state, shard, u, src, val, dest, staged, valid):
    """Ship each shard's top ``cfg.comm_quota`` staged URLs by value (ties
    in pool order, so parked retries outrank equal-value newcomers), park
    the rest. ``comm_quota < 0`` lifts the bound: the shipped set is the
    exchange mode's. A dead shard ships nothing but still parks."""
    quota = ctx.cfg.comm_quota
    z = torch.zeros_like(valid)
    if quota < 0:
        ship = valid
    else:
        # a stable descending sort's permutation, inverted into ranks
        key = torch.where(valid, val, torch.full_like(val, -float("inf")))
        order = torch.sort(key, dim=1, descending=True, stable=True).indices
        iota = torch.arange(key.shape[1], device=key.device).expand_as(order)
        rank = torch.empty_like(order).scatter_(1, order, iota)
        ship = valid & (rank < quota)
    return DispatchPlan(ship=ship, keep=z, defer=staged & ~ship, drop=z,
                        foreign=z)


EXCHANGE = register_coordination(CoordinationPolicy(
    "exchange", True, False, False, _exchange_plan))
FIREWALL = register_coordination(CoordinationPolicy(
    "firewall", False, False, False, _firewall_plan))
CROSSOVER = register_coordination(CoordinationPolicy(
    "crossover", False, False, True, _crossover_plan))
BATCHED = register_coordination(CoordinationPolicy(
    "batched", True, True, False, _batched_plan))
