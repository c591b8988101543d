"""The port's f32 row sums with one fixed order.

XLA's CPU row reduction adds in an order of its own that no PyTorch call
reproduces, and a CUDA reduction adds in yet another. Every f32 row sum on
the OPIC value channel goes through this module instead, so that the CPU
and the card give the same bits: a halving tree (``a[:h] + a[h:]``) over
the row zero-padded to a power of two, made of elementwise adds only, and
for rows longer than a tile, one tree per tile added up tile after tile
from 0. A CUDA shared-memory reduction that pairs thread ``i`` with
``i + h`` computes the same tree (``csrc/dedup_deposit.cu``).
"""
from __future__ import annotations

import torch

TILE = 256


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by a halving tree over its zero-padded
    power-of-two width. Returns x.shape[:-1]."""
    w = x.shape[-1]
    p = 1 << max(w - 1, 0).bit_length()
    if p != w:
        x = torch.nn.functional.pad(x, (0, p - w))
    while p > 1:
        p //= 2
        x = x[..., :p] + x[..., p:]
    return x[..., 0]


def row_sum(x: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Sum over the last axis: ``tree_sum`` of each tile of ``tile``
    items, added in tile order to a zero accumulator. Returns
    x.shape[:-1]."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for t0 in range(0, x.shape[-1], tile):
        acc = acc + tree_sum(x[..., t0:t0 + tile])
    return acc
