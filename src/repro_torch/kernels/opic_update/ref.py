"""The plain PyTorch version of the ``opic_update`` kernel.

Replays the TPU kernel's contract (repro/kernels/opic_update): the items of
each batch row are walked in tiles of ``tile``, in order, and every masked
item adds its contribution to its target, so that contributions to one
target accumulate in item order, exactly. Targets in [-R, 0) wrap to
[0, R) as JAX's indexing does; masked items and targets outside [-R, R)
drop. The update is IN PLACE on ``cash``.

Item order without atomics: the items of a tile are stably sorted by
target, each item gets its rank among the items before it with the same
target, and round j adds the items of rank j. No two items of a round
share a target, so each round is a plain indexed add, the same on the CPU
and on the card.
"""
from __future__ import annotations

import torch


def _targets(rows: torch.Tensor, mask: torch.Tensor, n: int):
    """(target in [0, n), ok): JAX's wrap of [-n, 0) and its drop rule."""
    rows = rows.to(torch.int64)
    ok = mask & (rows >= -n) & (rows < n)
    return torch.where(rows < 0, rows + n, rows), ok


def add_in_item_order(cash: torch.Tensor, tgt: torch.Tensor,
                      val: torch.Tensor, ok: torch.Tensor) -> None:
    """cash (B, R) += the ``ok`` items of (B, T), ``tgt`` in [0, R), each
    target's items added in item order."""
    B, T = tgt.shape
    R = cash.shape[1]
    key = torch.where(ok, torch.arange(B, device=tgt.device)[:, None] * R
                      + tgt, torch.full_like(tgt, B * R)).reshape(-1)
    skey, perm = torch.sort(key, stable=True)
    iota = torch.arange(key.numel(), device=key.device)
    start = torch.ones_like(skey, dtype=torch.bool)
    start[1:] = skey[1:] != skey[:-1]
    first = torch.cummax(torch.where(start, iota, torch.zeros_like(iota)),
                         dim=0).values
    rank = torch.empty_like(iota).scatter_(0, perm, iota - first)
    rank = torch.where(ok.reshape(-1), rank, torch.full_like(rank, -1))
    b = torch.arange(B, device=tgt.device).repeat_interleave(T)
    t, v = tgt.reshape(-1), val.reshape(-1)
    for j in range(int(rank.max()) + 1):
        sel = rank == j
        bj, tj = b[sel], t[sel]
        cash[bj, tj] = cash[bj, tj] + v[sel]


def opic_ref(cash: torch.Tensor, rows: torch.Tensor, contrib: torch.Tensor,
             mask: torch.Tensor, *, tile: int = 256) -> torch.Tensor:
    """cash (B, R) f32, updated in place and returned; rows (B, N) int,
    contrib (B, N) f32, mask (B, N) bool."""
    R, N = cash.shape[1], rows.shape[1]
    tgt, ok = _targets(rows, mask, R)
    for t0 in range(0, N, min(tile, N)):
        sl = slice(t0, t0 + tile)
        add_in_item_order(cash, tgt[:, sl], contrib[:, sl], ok[:, sl])
    return cash
