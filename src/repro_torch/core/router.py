"""Capacity-bucketed destination routing — the dispatch primitive.
Counterpart of ``repro/core/router.py``.

``position_in_bucket`` assigns each item its slot in its destination's
bucket (arrival order kept; items past ``capacity`` drop), ``pack_buckets``
scatters the items into (n_dest, capacity) buckets, each source shard its
own when the items carry a leading shard axis, and ``exchange`` is the
all_to_all of the JAX module: over a crawl group (``repro_torch.dist``)
an ``all_to_all_single`` between its ranks, within one process a
transpose of the leading shard axes. ``moe_capacity`` sizes an MoE layer's expert buckets
(``models/layers.moe_block`` routes through ``position_in_bucket``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def position_in_bucket(dest: torch.Tensor, n_dest: int, capacity: int, *,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dest (..., N) destination per item (trailing axis = items; leading
    axes are independent batches, e.g. source shards). Returns (slot
    (..., N), keep (..., N)): slot is the item's position within its bucket
    counted over the valid items before it in its batch; keep is False past
    ``capacity`` or where not valid."""
    d = dest.to(torch.int64)
    # the one-hot laid out (..., n_dest, N), so the count runs along the
    # innermost axis: the card scans an outer axis with one thread a
    # column, one item after another (13 ms for an MoE layer's 49,152)
    onehot = d[..., None, :] == torch.arange(n_dest, device=d.device)[:, None]
    if valid is not None:
        onehot = onehot & valid[..., None, :]
    upto = torch.cumsum(onehot, dim=-1, dtype=torch.int64)       # inclusive
    slot = torch.gather(upto, -2, d[..., None, :])[..., 0, :] - (
        1 if valid is None else valid.to(torch.int64))
    keep = slot < capacity
    if valid is not None:
        keep = keep & valid
    return slot, keep


def pack_buckets(payload: torch.Tensor, dest: torch.Tensor, n_dest: int,
                 capacity: int, *, valid: Optional[torch.Tensor] = None,
                 fill=0, return_keep: bool = False):
    """Scatter items payload (..., N, ...) into buckets (..., n_dest,
    capacity, ...), where ``dest`` is (..., N): each leading batch (a
    source shard) packs its own buckets, in its own arrival order.

    Returns (buckets, bucket_mask (..., n_dest, capacity) bool, dropped
    count per batch) and, with ``return_keep``, the per-item keep mask.
    Kept items own distinct (batch, dest, slot) cells, so the scatter has
    no collisions."""
    slot, keep = position_in_bucket(dest, n_dest, capacity, valid=valid)
    lead = tuple(dest.shape[:-1])
    buckets = torch.full(lead + (n_dest, capacity)
                         + tuple(payload.shape[dest.dim():]), fill,
                         dtype=payload.dtype, device=payload.device)
    mask = torch.zeros(lead + (n_dest, capacity), dtype=torch.bool,
                       device=payload.device)
    idx = keep.nonzero(as_tuple=True)
    cell = (*idx[:-1], dest.to(torch.int64)[idx], slot[idx])
    buckets[cell] = payload[idx]
    mask[cell] = True
    n_valid = (valid.sum(-1) if valid is not None
               else torch.full(lead, dest.shape[-1], device=dest.device))
    dropped = n_valid - keep.sum(-1)
    if return_keep:
        return buckets, mask, dropped, keep
    return buckets, mask, dropped


def exchange(buckets: torch.Tensor, group=None) -> torch.Tensor:
    """All-to-all over the shards: ``buckets`` is (n_src, n_dest,
    capacity, ...), this process's source shards' buckets for every
    destination shard; shard i's bucket j goes to shard j's row i. Shard
    j then holds every source's bucket j in source order, as the JAX
    package's tiled ``all_to_all`` (``concat_axis=0``) leaves it. Within
    one process (``group`` None or of one rank) that is a transpose of the
    two leading axes. Over a crawl group of W ranks, each holding L source
    and L destination shards, rank r sends ``buckets[:, q*L:(q+1)*L]`` to
    rank q in one ``all_to_all_single`` (every split the same size: the
    capacity is fixed) and gets (L, N, capacity, ...) back."""
    if group is None or group.world == 1:
        return buckets.transpose(0, 1).contiguous()
    import torch.distributed as dist
    L, N = buckets.shape[:2]
    rest = tuple(buckets.shape[2:])
    W = group.world
    # (W_dst, L_src, L_dst, ...): the chunk for rank q first
    send = buckets.reshape((L, W, N // W) + rest).transpose(0, 1)
    send = send.contiguous()
    recv = torch.empty_like(send)              # (W_src, L_src, L_dst, ...)
    from repro_torch.sharding import spmd
    spmd.count_collective("all-to-all", send.numel() * send.element_size())
    dist.all_to_all_single(recv, send)
    # -> (L_dst, W_src, L_src, ...) = (L_dst, N_src, ...)
    return recv.permute((2, 0, 1) + tuple(range(3, recv.dim()))
                        ).reshape((N // W, W * L) + rest).contiguous()


def moe_capacity(n_items: int, top_k: int, n_dest: int,
                 capacity_factor: float) -> int:
    """Slots a destination: ceil(n_items * top_k * capacity_factor /
    n_dest), rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(n_items * top_k * capacity_factor / n_dest))
    return max(8, -(-c // 8) * 8)
