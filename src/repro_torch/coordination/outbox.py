"""The per-shard URL outbox of the ``batched`` coordination mode.
Counterpart of ``repro/coordination/outbox.py``.

Four ``CrawlState`` leaves shaped like the staging buffer,

    outbox_url (n_shards, B) int64 holding uint32   outbox_val (n_shards, B)
    outbox_src (n_shards, B) int32                  outbox_n   (n_shards,)

with ``B = cfg.dispatch_capacity``, for the shards the process holds (a
rank's own under a crawl group). A parked URL keeps its source-page
domain and its ordering value; its destination is recomputed from the live
domain map at every retry, so after a C4 heal it follows its domain to the
new owner.

Per dispatch (``core/stages.dispatch_exchange``): ``merge_pool`` puts the
parked entries ahead of the fresh staging batch, every shard along the
leading axis at once; the policy picks what ships; ``park`` writes the
deferred rest back, and what does not fit in ``B`` refunds like any drop.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import CrawlConfig


def outbox_capacity(cfg: CrawlConfig) -> int:
    """One dispatch batch of carry."""
    return cfg.dispatch_capacity


def init_outbox(cfg: CrawlConfig, n_shards: int, device) -> Dict[str,
                                                                  torch.Tensor]:
    """Zeroed outbox leaves (every mode carries them; only ``batched``
    writes them)."""
    B = outbox_capacity(cfg)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return dict(outbox_url=zeros((n_shards, B), torch.int64),
                outbox_src=zeros((n_shards, B), torch.int32),
                outbox_val=zeros((n_shards, B), torch.float32),
                outbox_n=zeros((n_shards,), torch.int32))


def merge_pool(state, su: torch.Tensor, ss: torch.Tensor, sv: torch.Tensor,
               staged: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Prepend each shard's parked outbox to its staging batch: the pool is
    (n_shards, B + S). Returns (u, src, val, staged', parked), ``parked``
    marking the outbox-origin prefix."""
    B = state.outbox_url.shape[1]
    parked = (torch.arange(B, device=su.device)[None]
              < state.outbox_n[:, None])
    return (torch.cat([state.outbox_url, su], dim=1),
            torch.cat([state.outbox_src, ss], dim=1),
            torch.cat([state.outbox_val, sv], dim=1),
            torch.cat([parked, staged], dim=1), parked)


def park(u: torch.Tensor, src: torch.Tensor, val: torch.Tensor,
         defer: torch.Tensor, B: int) -> Tuple[Dict[str, torch.Tensor],
                                                torch.Tensor]:
    """Pack each shard's deferred items (n_shards, P) into a fresh outbox,
    pool order kept. Returns (outbox leaves, fits); ``fits`` marks the
    deferred items that parked, and the caller refunds and counts the rest.
    A parked item's position is its rank among the shard's deferred items,
    so positions are distinct; every item that does not park writes a zero
    into a trash column B, dropped after the scatter."""
    order = torch.cumsum(defer.to(torch.int64), dim=1) - 1
    fits = defer & (order < B)
    pos = torch.where(fits, order, torch.full_like(order, B))

    def put(vals, dtype):
        buf = torch.zeros((u.shape[0], B + 1), dtype=dtype, device=u.device)
        buf.scatter_(1, pos, torch.where(fits, vals,
                                         torch.zeros_like(vals)).to(dtype))
        return buf[:, :B]

    leaves = dict(outbox_url=put(u, torch.int64),
                  outbox_src=put(src, torch.int32),
                  outbox_val=put(val, torch.float32),
                  outbox_n=fits.sum(1).to(torch.int32))
    return leaves, fits
