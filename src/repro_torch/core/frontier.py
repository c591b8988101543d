"""The Global URL Frontier — Phase I's partitioned, prioritized URL queues.
Counterpart of ``repro/core/frontier.py``.

One row per domain slot; each row is a fixed-capacity priority queue whose
``priority`` encodes (bucket, FIFO arrival) as in the paper's Fig. 5. The
pop (``select``, ``select_harvest``) and the inserts write the row tensors
IN PLACE, where the JAX module returned new arrays; a Frontier's tensors
are the crawl state's. The valued forms (``select_harvest``,
``insert_valued``, ``place_valued``) also keep a cell-aligned cash table —
the ``opic_url`` ordering's lane — in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.frontier_select.ops import select as _kernel_select
from repro_torch.kernels.frontier_select.ops import \
    select_harvest as _kernel_harvest
from repro_torch.kernels.frontier_select.ref import NEG
from repro_torch.kernels.opic_update.ops import scatter_cash_cells
from repro_torch.kernels.rowsum import row_sum

_FIFO_RANGE = 1 << 20          # max arrivals distinguishable within a bucket


class Frontier(NamedTuple):
    url: torch.Tensor          # (R, C) int64 holding uint32 URL ids
    priority: torch.Tensor     # (R, C) f32; NEG when the cell is invalid
    valid: torch.Tensor        # (R, C) bool
    arrival: torch.Tensor      # (R,) int32 — per-row arrival counter
    n_dropped: torch.Tensor    # (R,) int32 — overflow drops
    n_inserted: torch.Tensor   # (R,) int32
    n_rebased: torch.Tensor    # (R,) int32 — FIFO tie-break rebase events


def init_frontier(n_rows: int, capacity: int, device) -> Frontier:
    z = torch.zeros((n_rows,), dtype=torch.int32, device=device)
    return Frontier(
        url=torch.zeros((n_rows, capacity), dtype=torch.int64, device=device),
        priority=torch.full((n_rows, capacity), NEG, dtype=torch.float32,
                            device=device),
        valid=torch.zeros((n_rows, capacity), dtype=torch.bool, device=device),
        arrival=z, n_dropped=z.clone(), n_inserted=z.clone(),
        n_rebased=z.clone())


def encode_priority(score: torch.Tensor, arrival_seq: torch.Tensor,
                    n_buckets: int) -> torch.Tensor:
    """score in [0,1) -> bucketed priority with FIFO tie-break: higher
    bucket wins; within a bucket, earlier arrival wins. Every value is an
    f32 integer below 2^24, so the encoding is exact."""
    bucket = torch.clamp((score * n_buckets).to(torch.int32), 0,
                         n_buckets - 1)
    return (bucket.to(torch.float32) * _FIFO_RANGE
            - torch.clamp(arrival_seq, max=_FIFO_RANGE - 1).to(torch.float32))


def _decode_arrival(priority: torch.Tensor) -> torch.Tensor:
    """Invert encode_priority for valid cells: b = ceil(pri / RANGE),
    a = b * RANGE - pri (exact in f32)."""
    b = torch.ceil(priority / _FIFO_RANGE)
    return b * _FIFO_RANGE - priority


def _rebase_fifo(f: Frontier, incoming: torch.Tensor) -> Frontier:
    """Compact each row's FIFO arrival sequence to live RANKS when the
    counter nears ``_FIFO_RANGE`` (stable sort, so live arrivals keep their
    strict order). The JAX module guards the sort with ``lax.cond``; here
    the guard is a Python ``if``, which costs a host sync per insert."""
    need = (f.arrival + incoming) >= (_FIFO_RANGE - 1)             # (R,)
    if not bool(need.any()):
        return f
    arr = _decode_arrival(f.priority)
    key = torch.where(f.valid, arr,
                      torch.full_like(arr, float(_FIFO_RANGE)))
    order = torch.sort(key, dim=1, stable=True).indices
    iota = torch.arange(key.shape[1], device=key.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(1, order, iota).to(torch.float32)
    bucket = torch.ceil(f.priority / _FIFO_RANGE)
    pri = torch.where(f.valid & need[:, None],
                      bucket * _FIFO_RANGE - rank, f.priority)
    n_live = f.valid.sum(dim=1).to(torch.int32)
    f.priority.copy_(pri)
    return f._replace(arrival=torch.where(need, n_live, f.arrival),
                      n_rebased=f.n_rebased + need.to(torch.int32))


def bucket_occupancy(priority: torch.Tensor, valid: torch.Tensor,
                     n_buckets: int, *, groups: Optional[int] = None
                     ) -> torch.Tensor:
    """Valid-URL count per priority bucket, summed over rows ->
    (n_buckets,) f32; with ``groups``, the rows split into that many equal
    consecutive groups (a shard's rows) -> (groups, n_buckets). An integer
    scatter-add with no host sync (invalid cells count in a dropped trash
    bucket)."""
    g = 1 if groups is None else groups
    b = torch.ceil(priority / _FIFO_RANGE).to(torch.int64)
    b = torch.where(valid, torch.clamp(b, 0, n_buckets - 1),
                    torch.full_like(b, n_buckets)).reshape(g, -1)
    occ = torch.zeros((g, n_buckets + 1), dtype=torch.int64,
                      device=priority.device)
    occ.scatter_add_(1, b, torch.ones_like(b))
    occ = occ[:, :n_buckets].to(torch.float32)
    return occ[0] if groups is None else occ


def select_arrays(url: torch.Tensor, priority: torch.Tensor,
                  valid: torch.Tensor, *, k: int, return_idx: bool = False):
    """Top-k pop on raw row arrays through the ``frontier_select`` kernel
    (its plain version on the CPU). Returns (urls (R,k), priorities (R,k),
    mask (R,k), priority', valid'[, idx (R,k)]); priority' and valid' ARE
    ``priority`` and ``valid``, popped in place. Masked lanes carry url 0."""
    out = _kernel_select(url, priority, valid, k=k, return_idx=return_idx)
    return (*out[:3], priority, valid, *out[3:])


def select(f: Frontier, k: int, *, return_idx: bool = False):
    """Pop the top-k URLs of every row (the URL allocator's read). Returns
    (urls (R,k), priorities (R,k), mask (R,k), frontier[, idx])."""
    out = select_arrays(f.url, f.priority, f.valid, k=k,
                        return_idx=return_idx)
    return (*out[:3], f, *out[5:])


def select_harvest(f: Frontier, table: torch.Tensor, k: int):
    """Pop plus url-lane harvest in one ``select_harvest`` launch: pops the
    top-k of every row, reads each popped cell's cash from ``table`` (R, C)
    and zeroes that cell, all in place. Returns (urls, priorities, mask,
    frontier, idx, cash), each of the arrays (R, k). Invalid cells already
    hold 0, so zeroing the popped cells leaves the table as the unfused
    ``where(valid', table, 0)`` would."""
    urls, pri, mask, idx, cash = _kernel_harvest(f.url, f.priority, f.valid,
                                                 table, k=k)
    return urls, pri, mask, f, idx, cash


def _plan_insert(f: Frontier, urls: torch.Tensor, scores: torch.Tensor,
                 mask: torch.Tensor, *, n_buckets: int):
    """FIFO rebase, priority encoding, and free-slot targeting. Returns
    (rebased frontier, pri, fits, tgt_safe, incoming); ``tgt_safe`` (R, M)
    is each item's column, C for items that do not fit."""
    R, C = f.url.shape
    incoming = mask.sum(dim=1).to(torch.int32)                     # (R,)
    f = _rebase_fifo(f, incoming)
    order = torch.cumsum(mask.to(torch.int32), dim=1) - 1          # (R, M)
    pri = encode_priority(scores, f.arrival[:, None] + order, n_buckets)
    # the o-th incoming item goes to the o-th free cell in column order:
    # scatter each free cell's column at its rank among the free cells
    free = ~f.valid
    rank = torch.cumsum(free.to(torch.int64), dim=1) - free.to(torch.int64)
    n_free = free.sum(dim=1)
    iota = torch.arange(C, device=f.url.device).expand(R, C)
    free_idx = torch.full((R, C + 1), C, dtype=torch.int64,
                          device=f.url.device)
    free_idx.scatter_(1, torch.where(free, rank, torch.full_like(rank, C)),
                      iota)
    free_idx[:, C] = C                    # the column every non-free cell hit
    fits = mask & (order < n_free[:, None])
    tgt = torch.gather(free_idx, 1, torch.clamp(order, 0, C - 1).to(
        torch.int64))
    tgt_safe = torch.where(fits, tgt, torch.full_like(tgt, C))
    return f, pri, fits, tgt_safe, incoming


def _apply_insert(f: Frontier, urls: torch.Tensor, pri: torch.Tensor,
                  mask: torch.Tensor, fits: torch.Tensor,
                  tgt_safe: torch.Tensor, incoming: torch.Tensor) -> Frontier:
    R = f.url.shape[0]
    rows = torch.arange(R, device=f.url.device)[:, None].expand(tgt_safe.shape)
    r, c = rows[fits], tgt_safe[fits]
    f.url[r, c] = urls[fits]
    f.priority[r, c] = pri[fits]
    f.valid[r, c] = True
    return f._replace(
        arrival=f.arrival + incoming,
        n_dropped=f.n_dropped + (mask & ~fits).sum(dim=1).to(torch.int32),
        n_inserted=f.n_inserted + fits.sum(dim=1).to(torch.int32))


def insert(f: Frontier, urls: torch.Tensor, scores: torch.Tensor,
           mask: torch.Tensor, *, n_buckets: int) -> Frontier:
    """Insert up to M URLs per row into free cells (the dispatcher's
    write). urls/scores/mask: (R, M). Items beyond the row's free capacity
    are dropped and counted in ``n_dropped``."""
    f, pri, fits, tgt_safe, incoming = _plan_insert(
        f, urls, scores, mask, n_buckets=n_buckets)
    return _apply_insert(f, urls, pri, mask, fits, tgt_safe, incoming)


def insert_valued(f: Frontier, table: torch.Tensor, urls: torch.Tensor,
                  scores: torch.Tensor, mask: torch.Tensor,
                  values: torch.Tensor, *, n_buckets: int):
    """``insert`` that carries a value per URL: each inserted URL's value
    is added (``opic_update`` kernel, cells form) into ``table`` (R, C) at
    the cell the URL takes. Items that do not fit refund their value per
    row. Returns (frontier, table, refund (R,)); table in place."""
    f2, pri, fits, tgt_safe, incoming = _plan_insert(
        f, urls, scores, mask, n_buckets=n_buckets)
    out = _apply_insert(f2, urls, pri, mask, fits, tgt_safe, incoming)
    scatter_cash_cells(table, None, tgt_safe, values, fits)
    refund = row_sum(torch.where(mask & ~fits, values,
                                 torch.zeros_like(values)))
    return out, table, refund


def place_valued(f: Frontier, table: torch.Tensor, urls: torch.Tensor,
                 mask: torch.Tensor, values: torch.Tensor):
    """``insert_valued`` at PLACEHOLDER priorities (bucket 0, pri =
    -arrival): the same cells, drops and refunds without a score pass. The
    caller must ``rescore`` the queue before its priorities are read."""
    zero = torch.zeros(urls.shape, dtype=torch.float32, device=urls.device)
    return insert_valued(f, table, urls, zero, mask, values, n_buckets=1)


def rescore(f: Frontier, scores: torch.Tensor, *, n_buckets: int
            ) -> Frontier:
    """Re-bucket every queued URL from ``scores`` (R, C), keeping its FIFO
    arrival stamp; invalid cells keep NEG. In place."""
    pri = encode_priority(scores, _decode_arrival(f.priority), n_buckets)
    f.priority.copy_(torch.where(f.valid, pri, f.priority))
    return f


def occupancy(f: Frontier) -> torch.Tensor:
    return f.valid.sum(dim=1)
