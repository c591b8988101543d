"""The crawl group: W crawl processes, one a card, each owning a run of
consecutive shards. The counterpart of the reference's mesh axis inside a
``shard_map``: where the reference names a collective (``psum``,
``all_gather``; the dispatch's ``lax.all_to_all`` is
``core/router.exchange``), the port calls it here over
``torch.distributed``.

Rank r of a group of W owns shards r * L ... r * L + L - 1 of N, L = N / W,
and runs the batched one-card code over its L shards as a leading axis.
Without a process group the group is one process of rank 0, and every
collective below returns its input: the one-card session is the case
W = 1. ``launch.mesh.init_crawl_group`` starts a group (NCCL on the card,
gloo only for an explicit ``cpu``).

Every collective moves integers or bits. An f32 is never reduced across
ranks (NCCL's ring would add in an order of its own): it travels as its
bits and is added where it lands, in the one-card order.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch


class CrawlGroup:
    """``world`` processes, this one of rank ``rank``. Built from the
    default process group by :meth:`current`."""

    def __init__(self, world: int = 1, rank: int = 0):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a group of {world}")
        self.world, self.rank = int(world), int(rank)

    @classmethod
    def current(cls) -> "CrawlGroup":
        """The default process group's size and rank; one process without
        one."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return cls(dist.get_world_size(), dist.get_rank())
        return cls()

    def __repr__(self) -> str:
        return f"CrawlGroup(world={self.world}, rank={self.rank})"

    def split(self, n: int) -> Tuple[int, int]:
        """(count, first) of this rank's consecutive share of ``n`` items
        (shards, rows). Raises when the world does not divide ``n``."""
        if n % self.world:
            raise ValueError(f"a world of {self.world} processes does not "
                             f"divide {n} shards")
        count = n // self.world
        return count, self.rank * count

    def local(self, x, n: Optional[int] = None):
        """This rank's slice of a leading axis of length ``n`` (default:
        ``x``'s own), for a tensor or a numpy array."""
        count, first = self.split(x.shape[0] if n is None else n)
        per = x.shape[0] // (count * self.world)
        return x[first * per:(first + count) * per]

    # -- collectives ---------------------------------------------------------

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order, on
        every rank (``lax.all_gather`` with tiling)."""
        if self.world == 1:
            return t
        import torch.distributed as dist
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        wire = wire.contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(parts, wire)
        out = torch.cat(parts, dim=dim)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def sum_int(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's integer ``t`` (``lax.psum``), exact."""
        if t.is_floating_point():
            raise TypeError("sum_int adds integers only: an f32 sum across "
                            "ranks would add in the collective's order")
        if self.world == 1:
            return t
        import torch.distributed as dist
        out = t.clone()
        dist.all_reduce(out)
        return out

    def broadcast(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s ``obj`` on every rank (a small picklable)."""
        if self.world == 1:
            return obj
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier()

    def refuse_moves(self, what: str) -> None:
        """Under W > 1, refuse a call that moves frontier and Bloom rows
        between shards: the rows would cross ranks, which the port does
        not do yet."""
        if self.world > 1:
            raise NotImplementedError(
                f"{what} moves rows between shards, and under a group of "
                f"{self.world} processes they would cross cards: not ported "
                f"(ROADMAP.md, Queue 1, item 19a: heal and rebalance across "
                f"cards)")
