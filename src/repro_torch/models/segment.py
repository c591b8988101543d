"""Gathers and segment sums that add in a fixed order, for the GAT's
message passing and the RecSys lookups.

The reference builds both from ``jnp.take``, ``jax.ops.segment_sum`` and
``segment_max``. On the card ``index_add_``, ``scatter_add_`` and the
backward of a plain gather add with atomics, whose order changes from run
to run (the crawl bars ``index_add_`` for that reason). Here every sum
over a segment runs in one order: a stable sort of the items' segment ids
puts the items in segment order, each item keeping its place within its
segment (the order in which XLA's serial scatter on the CPU adds them),
and ``torch.segment_reduce`` adds each segment's items in that order. A
gather's backward is the same segment sum of its gradient, so gradients
come out the same bits on every run too. The sort and the counts are made
once per ``Segments`` and shared by every gather and sum over that index.
"""
from __future__ import annotations

from typing import Optional

import torch


class Segments:
    """Items mapped to segments ``[0, n)`` by ``index`` (any shape, taken
    flat). ``perm`` (a stable sort of the items by segment) and
    ``lengths`` (items per segment) are made on first use, with no host
    sync."""

    def __init__(self, index: torch.Tensor, n: int):
        self.index = index.reshape(-1).long()
        self.n = int(n)
        self._perm: Optional[torch.Tensor] = None
        self._lengths: Optional[torch.Tensor] = None

    @property
    def perm(self) -> torch.Tensor:
        if self._perm is None:
            self._perm = torch.sort(self.index, stable=True).indices
        return self._perm

    @property
    def lengths(self) -> torch.Tensor:
        if self._lengths is None:
            # integer adds: the same counts in any order
            self._lengths = torch.zeros(
                self.n, dtype=torch.long, device=self.index.device
            ).scatter_add_(0, self.index, torch.ones_like(self.index))
        return self._lengths


def _reduce(x: torch.Tensor, seg: Segments, op: str) -> torch.Tensor:
    """(items, ...) -> (n, ...): each segment's items reduced in order;
    an empty segment's sum is 0 and its max -inf."""
    return torch.segment_reduce(x.index_select(0, seg.perm), op,
                                lengths=seg.lengths, axis=0, unsafe=True)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return _reduce(x, seg, "sum")

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.seg.index), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return x.index_select(0, seg.index)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.seg, "sum"), None


def segment_sum(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``jax.ops.segment_sum(x, seg.index, num_segments=seg.n)``."""
    return _SegmentSum.apply(x, seg)


def segment_max(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``jax.ops.segment_max`` (an empty segment gives -inf), without a
    gradient: its one caller, the GAT's softmax shift, cancels out of the
    function's value and so of its exact gradient."""
    return _reduce(x.detach(), seg, "max")


def gather(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``x[seg.index]`` along the leading axis (the indices must lie in
    ``[0, seg.n)``, with ``seg.n == x.shape[0]``); its gradient is a
    segment sum in the fixed order."""
    return _Gather.apply(x, seg)
