"""OPIC at per-URL granularity — the ``opic_url`` ordering. Counterpart of
``repro/ordering/opic_url.py``.

``CrawlState.order_state`` widens to (n_slots, 2 + frontier_capacity):
column 0 is the slot cash, column 1 the slot history, and columns 2: the
per-URL cash lane, cell-aligned with the frontier queues (cell (r, c) holds
the cash of ``f_url[r, c]``; invalid cells hold exactly 0.0).

  * pop     — ``allocate`` harvests each popped URL's cell into
    ``StepCarry.url_cash`` and zeroes the cell (the ``select_harvest``
    kernel under ``cfg.fused_dispatch``); give-backs re-deposit at the
    URL's new cell (``frontier.insert_valued``).
  * spend   — the update stage below: each fetched page spends its
    harvested cash plus an equal share of its slot's cash; every outlink's
    1/O share rides the value channel.
  * deliver — ``dispatch_exchange`` drops a received URL's cash into the
    cell the URL wins; a Bloom-duplicate whose URL is still queued adds to
    the existing cell (the ``dedup_deposit`` kernel when fused); arrivals
    with no queued twin and overflow refund to the row's slot cash. The
    queue is then re-bucketed from the cells' cash (``frontier.rescore``).

Row sums go through ``kernels.rowsum`` (one fixed order on every device).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import partitioner as PT
from repro_torch.core import ranker
from repro_torch.core import webgraph as W
from repro_torch.kernels.rowsum import row_sum
from repro_torch.ordering.opic import (first_row, local_rows, row_shard,
                                       slot_importance)
from repro_torch.ordering.policies import (ORD_WIDTH, OrderingPolicy,
                                           register_ordering)

# score blend: slot-importance prior vs the URL's own accumulated cash vs
# the static within-domain popularity component
_W_PRIOR, _W_URL, _W_POP = 0.4, 0.15, 0.45


def init_opic_url(cfg: CrawlConfig, n_shards: int, device) -> torch.Tensor:
    """Unit cash on domain-bearing slots; empty history and URL lane."""
    dm = PT.identity_map(cfg, n_shards, device)
    out = torch.zeros((cfg.n_slots, ORD_WIDTH + cfg.frontier_capacity),
                      dtype=torch.float32, device=device)
    out[:, 0] = (dm.domain_of_slot >= 0).to(torch.float32)
    return out


def url_cash_table(state) -> torch.Tensor:
    """The (n_slots, frontier_capacity) per-URL lane: a view of
    order_state."""
    return state.order_state[:, ORD_WIDTH:]


def make_opic_url_score_fn(cfg: CrawlConfig, *, n_shards: int, shard=0):
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
        # within-queue rank: the URL's cash relative to its row's mean
        # delivery (val is row-aligned 2-D at every stage call site)
        if val is None:
            s_url = torch.zeros_like(pop)
        else:
            n_pos = torch.clamp((val > 0).sum(dim=-1, keepdim=True), min=1)
            mean = row_sum(val)[..., None] / n_pos.to(torch.float32)
            s_url = val / (val + torch.clamp(mean, min=1e-9))
        # three products and two adds, each rounded to f32 (no fused
        # multiply-add, so the CPU and the card agree)
        s = torch.where(local,
                        _W_PRIOR * s_imp + _W_URL * s_url + _W_POP * pop,
                        ranker.score_urls(urls, cfg))
        return torch.clamp(s, 0.0, 0.999)

    return score


def opic_url_update(ctx, state, carry):
    """The per-URL OPIC spend step (between fetch_analyze and extract).
    Every contribution, local or remote, rides the value channel; the cell
    scatter happens at dispatch. Writes the slot columns in place."""
    cfg = ctx.cfg
    os_ = state.order_state
    cash, hist = os_[:, 0], os_[:, 1]
    zero = torch.zeros((), dtype=torch.float32, device=cash.device)

    # spend: each fetched page spends its harvested cell cash plus an
    # equal share of its slot's cash
    n_f = carry.sel.sum(dim=1)                                    # (r,)
    spend_slot = torch.where(n_f > 0, cash, zero)
    share = torch.where(
        carry.sel,
        (spend_slot / torch.clamp(n_f, min=1).to(torch.float32))[:, None],
        zero)                                                     # (r, k)
    page_spend = share + torch.where(carry.sel, carry.url_cash, zero)
    per_link = page_spend[..., None] / cfg.outlinks_per_page     # (r, k, 1)

    links = W.outlinks(carry.urls, cfg, ctx.cumw)                 # (r, k, O)
    lmask = carry.sel[..., None].expand(links.shape)
    contrib = torch.where(lmask, per_link.expand(links.shape), zero)

    os_[:, 1] = hist + row_sum(page_spend)
    os_[:, 0] = cash - spend_slot
    return state, carry._replace(link_cash=contrib, links=links,
                                 url_cash=torch.zeros_like(carry.url_cash)), {}


def make_opic_url_update_stage():
    """The per-URL OPIC spend step as a pipeline stage (between
    fetch_analyze and extract)."""
    return opic_url_update


OPIC_URL = register_ordering(OrderingPolicy(
    "opic_url", True, init_opic_url, make_opic_url_score_fn,
    opic_url_update, url_lane=True))
