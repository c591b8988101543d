"""Capacity-bucketed destination routing — the dispatch primitive.
Counterpart of ``repro/core/router.py``.

``position_in_bucket`` assigns each item its slot in its destination's
bucket (arrival order kept; items past ``capacity`` drop), ``pack_buckets``
scatters the items into (n_dest, capacity) buckets, and ``exchange`` is the
all_to_all of the JAX module written over a leading shard axis: a
transpose, the identity at one shard.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def position_in_bucket(dest: torch.Tensor, n_dest: int, capacity: int, *,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dest (N,) destination per item. Returns (slot (N,), keep (N,)):
    slot is the item's position within its bucket counted over the valid
    items before it; keep is False past ``capacity`` or where not valid."""
    onehot = torch.nn.functional.one_hot(dest.to(torch.int64), n_dest)
    if valid is not None:
        onehot = onehot * valid[..., None].to(onehot.dtype)
    pos = torch.cumsum(onehot, dim=-2) - onehot                   # exclusive
    slot = torch.gather(pos, -1, dest.to(torch.int64)[..., None])[..., 0]
    keep = slot < capacity
    if valid is not None:
        keep = keep & valid
    return slot, keep


def pack_buckets(payload: torch.Tensor, dest: torch.Tensor, n_dest: int,
                 capacity: int, *, valid: Optional[torch.Tensor] = None,
                 fill=0, return_keep: bool = False):
    """Scatter items payload (N, ...) into buckets (n_dest, capacity, ...).

    Returns (buckets, bucket_mask (n_dest, capacity) bool, dropped count)
    and, with ``return_keep``, the per-item keep mask. Kept items own
    distinct (dest, slot) cells, so the scatter has no collisions."""
    slot, keep = position_in_bucket(dest, n_dest, capacity, valid=valid)
    buckets = torch.full((n_dest, capacity) + tuple(payload.shape[1:]), fill,
                         dtype=payload.dtype, device=payload.device)
    d, s = dest.to(torch.int64)[keep], slot[keep]
    buckets[d, s] = payload[keep]
    mask = torch.zeros((n_dest, capacity), dtype=torch.bool,
                       device=payload.device)
    mask[d, s] = True
    n_valid = valid.sum() if valid is not None else dest.numel()
    dropped = n_valid - keep.sum()
    if return_keep:
        return buckets, mask, dropped, keep
    return buckets, mask, dropped


def exchange(buckets: torch.Tensor) -> torch.Tensor:
    """All-to-all over a leading shard axis: ``buckets`` is
    (n_src, n_dest, capacity, ...); shard i's bucket j goes to shard j's
    row i, i.e. a transpose of the two leading axes."""
    return buckets.transpose(0, 1).contiguous()
