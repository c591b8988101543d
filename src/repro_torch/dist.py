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

A heal or a rebalance moves rows between shards, and so between ranks:
``plan_move`` turns the source slot of every slot (the reference's gather
index, the same on every rank) into what this rank sends and receives,
and ``move_rows`` moves each named leaf's rows in place, one
``all_to_all_single`` a leaf, every source row read before any target
row is written. No rank holds more of a leaf than the rows it sends and
receives.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class RowMove(NamedTuple):
    """One rank's share of a row move: the local rows it reads, grouped by
    the rank each goes to (``send_splits`` rows a rank, in rank order),
    and the local rows it writes, grouped by the rank each comes from.
    Within a pair of ranks the rows travel in the order of their target
    slots."""
    send_rows: torch.Tensor     # (n_send,) int64 local rows read
    send_splits: List[int]      # (world,) rows sent to each rank
    recv_rows: torch.Tensor     # (n_recv,) int64 local rows written
    recv_splits: List[int]      # (world,) rows received from each rank
    n_moved: int                # rows that change slot, every rank's

    def pack(self, leaf: torch.Tensor) -> torch.Tensor:
        """The rows this rank sends, read from ``leaf`` (a bool leaf as
        uint8, its bits unchanged)."""
        wire = leaf.view(torch.uint8) if leaf.dtype == torch.bool else leaf
        return wire.index_select(0, self.send_rows)

    def unpack(self, leaf: torch.Tensor, recv: torch.Tensor) -> None:
        """Write the received rows into their target rows of ``leaf``."""
        wire = leaf.view(torch.uint8) if leaf.dtype == torch.bool else leaf
        wire.index_copy_(0, self.recv_rows, recv)


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

    def check_replicated(self, tensors: Sequence[torch.Tensor],
                         what: str) -> None:
        """Raise unless every rank holds the same ``tensors`` (the
        replicated control plane): a digest of their bytes is gathered
        and held to rank 0's."""
        if self.world == 1:
            return
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        mine = torch.tensor(list(h.digest()), dtype=torch.uint8,
                            device=tensors[0].device)
        every = self.gather(mine[None]).cpu()
        bad = [r for r in range(self.world) if not torch.equal(every[r],
                                                               every[0])]
        if bad:
            raise RuntimeError(f"{what}: ranks {bad} of {self.world} hold "
                               f"another plan than rank 0 (the control "
                               f"plane must be replicated)")

    # -- row moves -----------------------------------------------------------

    def plan_move(self, src: torch.Tensor) -> RowMove:
        """This rank's share of the gather ``new[t] = old[src[t]]`` over
        every slot t (``src``: the (n_slots,) global source slot of every
        slot, the same on every rank; a slot that keeps its row names
        itself). Rank r owns the r-th run of n_slots / W slots. The row
        indices lie on ``src``'s device."""
        at = src.cpu().numpy().astype(np.int64)
        per = self.split(at.shape[0])[0]
        first = self.rank * per
        tgt = np.flatnonzero(at != np.arange(at.shape[0]))
        frm = at[tgt]
        to_rank, from_rank = tgt // per, frm // per
        out = from_rank == self.rank          # tgt ascending: rank order
        into = np.flatnonzero(to_rank == self.rank)
        into = into[np.argsort(from_rank[into], kind="stable")]

        def rows(x):
            return torch.from_numpy(x - first).to(src.device)

        return RowMove(
            send_rows=rows(frm[out]),
            send_splits=np.bincount(to_rank[out],
                                    minlength=self.world).tolist(),
            recv_rows=rows(tgt[into]),
            recv_splits=np.bincount(from_rank[into],
                                    minlength=self.world).tolist(),
            n_moved=len(tgt))

    def move_rows(self, leaves: Dict[str, torch.Tensor],
                  src: torch.Tensor) -> RowMove:
        """Move the rows of every leaf of ``leaves`` (this rank's rows of
        row-indexed tensors) in place, so that each slot t holds what slot
        ``src[t]`` held (``plan_move``): each source row is read before
        any target row is written, so a slot vacated by one move may be
        another's target, and a moved row keeps a stale copy at its
        source unless a move overwrites it. Rows travel as their bits
        (bool as uint8), one ``all_to_all_single`` a leaf, so a rank holds
        at most one leaf's sent and received rows at once. Every rank
        makes the same calls. Returns the plan."""
        plan = self.plan_move(src)
        if not plan.n_moved:
            return plan
        for leaf in leaves.values():
            send = plan.pack(leaf)
            if self.world == 1:
                recv = send
            else:
                import torch.distributed as dist
                recv = send.new_empty((sum(plan.recv_splits),)
                                      + tuple(send.shape[1:]))
                dist.all_to_all_single(recv, send, plan.recv_splits,
                                       plan.send_splits)
            plan.unpack(leaf, recv)
            del send, recv
        return plan
