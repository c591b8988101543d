"""OPIC — On-line Page Importance Computation, per frontier SLOT.
Counterpart of ``repro/ordering/opic.py``.

``CrawlState.order_state[:, 0]`` is a slot's cash and ``[:, 1]`` its
history. Every domain-bearing slot starts with cash 1.0. At each step a
slot with fetches banks its cash into history and splits it over the
fetched pages' outlinks (1/O each): targets whose slot lives on this shard
are added through the ``opic_update`` kernel, in item order; the rest ride
the stages' value channel (``StepCarry.link_cash`` -> ``staging_val`` -> the
dispatch payload's value lane) and are delivered or refunded there. Total
cash is conserved up to f32 rounding in the split.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import partitioner as PT
from repro_torch.core import ranker
from repro_torch.core import webgraph as W
from repro_torch.kernels.opic_update.ops import scatter_cash
from repro_torch.ordering.policies import (ORD_WIDTH, OrderingPolicy,
                                           register_ordering)

# score blend: learned importance of the URL's domain slot vs the static
# within-domain popularity tie-break
_W_IMP, _W_POP = 0.7, 0.3


def init_opic(cfg: CrawlConfig, n_shards: int, device) -> torch.Tensor:
    """Uniform initial cash over domain-bearing slots; empty history."""
    dm = PT.identity_map(cfg, n_shards, device)
    cash = (dm.domain_of_slot >= 0).to(torch.float32)
    return torch.stack([cash, torch.zeros_like(cash)], dim=-1)


def row_shard(shard, like: torch.Tensor) -> torch.Tensor:
    """``shard`` (an int, or one shard per row of ``like``) shaped to
    broadcast against ``like`` (rows first)."""
    return torch.as_tensor(shard, device=like.device).reshape(
        (-1,) + (1,) * (like.dim() - 1))


def local_rows(urls: torch.Tensor, cfg: CrawlConfig, state, shard,
               r_slots: int):
    """The shard-local frontier row of each URL's domain slot, clamped into
    range, and whether that slot lives on the URL's shard (``shard``
    broadcasts against ``urls``)."""
    dom = torch.clamp(W.domain_of(urls, cfg), 0, cfg.n_domains - 1)
    row = state.slot_of_domain.to(torch.int64)[dom] - shard * r_slots
    return torch.clamp(row, 0, r_slots - 1), (row >= 0) & (row < r_slots)


def slot_importance(state, n_shards: int) -> torch.Tensor:
    """cash + history of every slot of the state, relative to the largest
    of its own shard (the JAX package's ``imp.max()`` over a shard's local
    rows); ``n_shards`` counts the shards the state holds."""
    imp = (state.order_state[:, 0] + state.order_state[:, 1]).view(
        n_shards, -1)
    top = torch.clamp(imp.max(dim=1, keepdim=True).values, min=1e-6)
    return (imp / top).reshape(-1)


def first_row(shard, r_slots: int) -> int:
    """The global slot of the state's first row: under a crawl group the
    state holds the rows of its own shards, from the first of ``shard``
    (an int, or the global shard of each of the state's rows) on. Read
    once, when a scorer is built."""
    return int(torch.as_tensor(shard).reshape(-1)[0]) * r_slots


def make_opic_score_fn(cfg: CrawlConfig, *, n_shards: int, shard=0):
    """``shard``: the global shard of each row of the URLs to score (rows
    first), or one int for all."""
    r_slots = cfg.n_slots // n_shards
    base = first_row(shard, r_slots)

    def score(urls, cfg, state, val=None):
        sh = row_shard(shard, urls)
        row, local = local_rows(urls, cfg, state, sh, r_slots)
        imp = slot_importance(state, state.order_state.shape[0] // r_slots)
        slot = sh * r_slots + row
        s_imp = imp[slot - base if base else slot]
        pop = W.popularity(urls, cfg)
        # URLs whose domain row lives on another shard fall back to the
        # static blend
        s = torch.where(local, _W_IMP * s_imp + _W_POP * pop,
                        ranker.score_urls(urls, cfg))
        return torch.clamp(s, 0.0, 0.999)

    return score


def opic_update(ctx, state, carry):
    """The OPIC spend step, a pipeline stage between fetch_analyze and
    extract. Writes the slot columns of ``order_state`` in place."""
    cfg, n = ctx.cfg, ctx.n_local
    os_ = state.order_state
    cash, hist = os_[:, 0], os_[:, 1]
    r_slots = cash.shape[0] // n

    # spend: a slot with fetches this step banks its cash into history
    n_f = carry.sel.sum(dim=1)                                    # (r,)
    spend = torch.where(n_f > 0, cash, torch.zeros_like(cash))
    share = torch.where(
        carry.sel,
        (spend / torch.clamp(n_f, min=1).to(torch.float32))[:, None],
        torch.zeros((), dtype=torch.float32, device=cash.device))  # (r, k)
    per_link = share[..., None] / cfg.outlinks_per_page          # (r, k, 1)

    # distribute along the fetched pages' outlinks (parsed once here and
    # cached in the carry for extract_stage)
    links = W.outlinks(carry.urls, cfg, ctx.cumw)                 # (r, k, O)
    lmask = carry.sel[..., None].expand(links.shape)
    contrib = per_link.expand(links.shape)
    tslot = state.slot_of_domain.to(torch.int64)[
        torch.clamp(W.domain_of(links, cfg), 0, cfg.n_domains - 1)]
    row = tslot - row_shard(carry.shard, links) * r_slots
    is_local = (row >= 0) & (row < r_slots) & lmask

    # local targets: the opic_update kernel's scatter-add, one launch over
    # every shard's r_slots targets (a shard's items hit only its own)
    new_cash = (cash - spend).view(n, r_slots)
    scatter_cash(new_cash, torch.clamp(row, 0, r_slots - 1).reshape(n, -1),
                 contrib.reshape(n, -1).contiguous(),
                 is_local.reshape(n, -1))

    # cross-shard targets ride the conserved value channel
    remote = torch.where(lmask & ~is_local, contrib, torch.zeros_like(contrib))
    os_[:, 1] = hist + spend
    os_[:, 0] = new_cash.reshape(-1)
    return state, carry._replace(link_cash=remote, links=links), {}


def make_opic_update_stage():
    """The OPIC spend step as a pipeline stage (between fetch_analyze and
    extract; ``core/stages.assemble_pipeline`` slots it in by itself)."""
    return opic_update


OPIC = register_ordering(OrderingPolicy(
    "opic", True, init_opic, make_opic_score_fn, opic_update))


# ---------------------------------------------------------------------------
# conservation accounting (host-side)
# ---------------------------------------------------------------------------

def _in_transit(vals: torch.Tensor, ns: torch.Tensor) -> float:
    v = vals.cpu().numpy().astype(np.float64)
    return sum(float(v[i, :int(n)].sum())
               for i, n in enumerate(ns.cpu().numpy()))


def total_cash(state) -> float:
    """Total OPIC cash: slot cash, the per-URL lane when the ordering keeps
    one (``opic_url``, order_state columns 2:), cash in transit in the
    staging buffers, and cash parked in the outbox. Conserved up to f32
    rounding in the spend split. Under a crawl group every rank calls it:
    the f32 leaves are gathered from every rank (as bits, never reduced
    across ranks) and added in the one-process order, so every rank gets
    the one-process sum."""
    from repro_torch.core.stages import join_state
    state = join_state(state)
    os_ = state.order_state.cpu().numpy().astype(np.float64)
    return (float(os_[:, 0].sum() + os_[:, ORD_WIDTH:].sum())
            + _in_transit(state.staging_val, state.staging_n)
            + _in_transit(state.outbox_val, state.outbox_n))


def total_wealth(state) -> float:
    """cash + history + in-transit — grows only by banked history."""
    from repro_torch.core.stages import join_state
    return total_cash(state) + float(
        join_state(state).order_state[:, 1].cpu().numpy().astype(
            np.float64).sum())
