"""The train mesh's collectives: what the reference's SPMD partitioner and
``shard_map`` do between devices, written out over ``torch.distributed``
for one process a card. Port only (the reference has XLA insert them).

Tensor parallelism follows one convention (Megatron's). Between layers an
activation is replicated over the "model" axis and each of its processes
holds its WHOLE gradient. Where a replicated tensor enters work that each
model process does on its own part (a column-parallel product, its own
heads or tokens), it passes ``tp_copy``: the identity, whose backward adds
the processes' partial gradients. Where such work ends, ``tp_reduce`` adds
the partial results (a row-parallel product) and ``tp_gather`` joins the
parts; their backwards pass the whole gradient on, or its own part. A
weight replicated over "model" that such work reads passes ``tp_copy``
too. So a parameter's gradient never needs a sum over "model" afterwards,
only over the data axes, which ``reduce_grad`` does (a reduce-scatter onto
an FSDP-sharded leaf, an all-reduce onto a data-replicated one).

Every function here is the identity, and launches nothing, over an axis
of size 1. An f32 sum across processes is the collective's sum, in its own
order: results match one card within a tolerance, not bit for bit.

Every collective made here (and by ``repro_torch.dist``'s crawl group) is
counted by kind (all-gather, reduce-scatter, all-reduce, all-to-all,
broadcast) with its operand's bytes, the reference's ``collectives`` and
``collective_bytes`` (``collectives``, ``reset_collectives``). A tensor on
``meta`` takes the collective's meta route, as the kernel wrappers do: the
result's shape, the count and the bytes, and no process group. The dry
run reckons one process's program of a mesh that way, under a
``MetaMesh`` (the mesh's shape and that process's coordinate).
"""
from __future__ import annotations

import contextlib
import weakref
from collections.abc import Mapping
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding import rules


# -- the count of collectives ----------------------------------------------

_COUNTS: Dict[str, list] = {}


def count_collective(kind: str, nbytes: int) -> None:
    """One collective of ``kind`` whose operand holds ``nbytes`` bytes."""
    c = _COUNTS.setdefault(kind, [0, 0])
    c[0] += 1
    c[1] += int(nbytes)


def reset_collectives() -> None:
    _COUNTS.clear()


def collectives() -> Dict[str, Dict[str, int]]:
    """{kind: {"count", "bytes"}} since the last ``reset_collectives``."""
    return {k: {"count": c[0], "bytes": c[1]} for k, c in
            sorted(_COUNTS.items())}


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class MetaMesh:
    """A mesh as one of its processes sees it, with no devices and no
    process group: the axis names and sizes of a mesh shape
    (``rules.mesh_sizes``) and the coordinate of process ``rank`` (the
    last axis minor). It stands in for a ``DeviceMesh`` wherever the
    models and the specs read one (``activation_mesh``, ``Axis``,
    ``rules.local_slices``); its collectives take the meta route, so it
    carries meta tensors only. The dry run reckons a mesh cell as one
    process's program under it."""

    def __init__(self, shape, rank: int = 0):
        sizes = rules.mesh_sizes(shape)
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        n = 1
        for s in self.shape:
            n *= s
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} outside a mesh of {n}")
        self.rank, self._size = rank, n
        coord, r = [], rank
        for s in reversed(self.shape):
            coord.append(r % s)
            r //= s
        self._coord = coord[::-1]

    def size(self) -> int:
        return self._size

    def get_coordinate(self):
        return list(self._coord)

    def get_local_rank(self, name: str) -> int:
        return self._coord[self.mesh_dim_names.index(name)]

    def get_group(self, name: str):
        return None

    def __repr__(self) -> str:
        return (f"MetaMesh({dict(zip(self.mesh_dim_names, self.shape))}, "
                f"rank={self.rank})")


class Axis:
    """One axis of a ``DeviceMesh`` as this process sees it: its size,
    this process's coordinate on it and its process group."""

    def __init__(self, mesh, name: str):
        self.name = name
        self.size = int(dict(zip(mesh.mesh_dim_names, mesh.shape))[name])
        self.index = int(mesh.get_local_rank(name))
        self.group = mesh.get_group(name)


def tp_axis() -> Optional[Axis]:
    """The active real mesh's "model" axis, or None (no real mesh)."""
    mesh = rules.active_device_mesh()
    return None if mesh is None else Axis(mesh, rules._ACT["tp"])


def dp_axes() -> Tuple[Axis, ...]:
    """The active real mesh's data axes (empty without one)."""
    mesh = rules.active_device_mesh()
    return () if mesh is None else tuple(Axis(mesh, a)
                                         for a in rules._ACT["dp"])


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    count_collective("all-reduce", _nbytes(x))
    if not x.is_meta:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The axis's parts of ``x`` joined along ``dim`` in axis order."""
    if axis.size == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((axis.size * src.shape[0],) + tuple(src.shape[1:]))
    count_collective("all-gather", _nbytes(src))
    if not src.is_meta:
        dist.all_gather_into_tensor(out, src, group=axis.group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The axis's sum of ``x``, this process's part of ``dim`` of it."""
    if axis.size == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // axis.size,) + tuple(src.shape[1:]))
    count_collective("reduce-scatter", _nbytes(src))
    if not src.is_meta:
        fn = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        fn(out, src, group=axis.group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM):
    return x if axis.size == 1 else _all_reduce(x, axis.group, op)


def local_part(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This process's part of ``dim`` (equal parts in axis order)."""
    if axis.size == 1:
        return x
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n)


# ---------------------------------------------------------------------------
# Autograd collectives over the model axis
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return local_part(g, ctx.dim, ctx.axis).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    """``x`` (axis.size * n, ...): part k goes to process k, and part k of
    the result came from process k. Its own inverse, so its backward is
    the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _a2a(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.axis), None


def _a2a(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if axis.size == 1:
        return x
    src = x.contiguous()
    out = torch.empty_like(src)
    count_collective("all-to-all", _nbytes(src))
    if not src.is_meta:
        dist.all_to_all_single(out, src, group=axis.group)
    return out


class _MeshMean(torch.autograd.Function):
    """The mean of a scalar over every process of the mesh (the
    reference's ``pmean`` over the data and model axes). Each data
    process's loss holds it once and the model processes hold the same
    loss, so each process's term gets the data processes' summed gradient
    over the mesh's size."""

    @staticmethod
    def forward(ctx, x, dps, tp):
        ctx.dps, ctx.n = dps, tp.size
        for a in dps:
            ctx.n *= a.size
        for a in (*dps, tp):
            x = all_reduce(x, a)
        return x / ctx.n

    @staticmethod
    def backward(ctx, g):
        for a in ctx.dps:
            g = all_reduce(g, a)
        return g / ctx.n, None, None


def tp_copy(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Identity; the backward adds the model processes' gradients."""
    return x if axis.size == 1 else _Copy.apply(x, axis)


def tp_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of the model processes' partial ``x``."""
    return x if axis.size == 1 else _Reduce.apply(x, axis)


def tp_gather(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The model processes' parts of ``x`` joined along ``dim``."""
    return x if axis.size == 1 else _Gather.apply(x, dim, axis)


def tp_split(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This model process's part of a replicated ``x`` along ``dim``."""
    return x if axis.size == 1 else local_part(tp_copy(x, axis), dim, axis)


def tp_all_to_all(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _AllToAll.apply(x, axis)


def mesh_mean(x: torch.Tensor, tp: Axis) -> torch.Tensor:
    return _MeshMean.apply(x, dp_axes(), tp)


def tp_max(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The model processes' elementwise max, without gradient."""
    return all_reduce(x.detach(), axis, dist.ReduceOp.MAX)


def gather_axes(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """The parts of ``x`` held along ``axes`` (major first) joined along
    ``dim``, in the mesh's order."""
    for axis in reversed(tuple(axes)):
        x = all_gather(x, dim, axis)
    return x


def heads_to_sequence(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x (B, H / n, S, hd), this process's heads over the whole sequence
    (n the axis's size), -> (B, H, S / n, hd), every head over this
    process's part of the sequence, in axis order: one all-to-all."""
    if axis.size == 1:
        return x
    B, hl, S, hd = x.shape
    n = axis.size
    parts = x.reshape(B, hl, n, S // n, hd).permute(2, 0, 1, 3, 4)
    got = _a2a(parts, axis)          # part k: process k's heads
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * hl, S // n, hd)


def merge_softmax(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                  axes) -> torch.Tensor:
    """The attention output of keys split over ``axes``, from each
    process's partial result over its own keys (f32): ``m`` its scores'
    max (-inf where it holds no valid key), ``l`` the sum of exp(s - m)
    and ``acc`` the unnormalised output (last dim hd). The max is taken
    over the axes, each part is rescaled to it (exp(-inf) = 0: a process
    without a valid key adds nothing), l and acc are added over the axes
    (one all-reduce an axis), and the output is acc / l."""
    mg = m
    for axis in axes:
        mg = all_reduce(mg, axis, dist.ReduceOp.MAX)
    scale = torch.exp(m - mg)
    both = torch.cat([l * scale, acc * scale], dim=-1)
    for axis in axes:
        both = all_reduce(both, axis)
    return both[..., 1:] / both[..., :1]


# ---------------------------------------------------------------------------
# FSDP over the data axes
# ---------------------------------------------------------------------------

def _mesh_axes(mesh):
    return {a: Axis(mesh, a) for a in rules.dp_axes(mesh)}


def _dp_dims(sharding, axes):
    """[(dim, axis)] of the data axes that split a leaf, major first."""
    out = []
    for d, entry in enumerate(sharding.spec):
        out += [(d, axes[a]) for a in rules._axes(entry) if a in axes]
    return out


def gather_params(local: torch.Tensor, sharding) -> torch.Tensor:
    """A leaf's block joined over the data axes that split it: its
    gather-once layout (``rules.drop_fsdp``), each process keeping its
    model part."""
    axes = _mesh_axes(sharding.mesh)
    for d, axis in reversed(_dp_dims(sharding, axes)):
        local = all_gather(local, d, axis)
    return local


def reduce_grad(grad: torch.Tensor, sharding) -> torch.Tensor:
    """A gradient in the gather-once layout summed over the data axes
    onto the leaf's own block: a reduce-scatter over an axis that splits
    it, an all-reduce over one that does not."""
    axes = _mesh_axes(sharding.mesh)
    split = _dp_dims(sharding, axes)
    for d, axis in split:
        grad = reduce_scatter(grad, d, axis)
    for a, axis in axes.items():
        if all(axis is not s for _, s in split):
            grad = all_reduce(grad, axis)
    return grad


class Block(NamedTuple):
    """A parameter's block on this process (or one layer's slice of a
    stacked leaf's block) and its sharding: what ``joined`` joins where
    the model uses it."""
    block: torch.Tensor
    sharding: object


class _Join(torch.autograd.Function):
    """A block joined over the data axes that split it (``gather_params``);
    the backward sums the gradient over the data axes onto the block
    (``reduce_grad``: a reduce-scatter) the moment it is made."""

    @staticmethod
    def forward(ctx, block, sharding):
        ctx.sharding = sharding
        return gather_params(block, sharding)

    @staticmethod
    def backward(ctx, g):
        return reduce_grad(g, ctx.sharding), None


_RELEASE: list = []    # the open ``released`` scopes' joined tensors


def joined(x):
    """A ``Block`` joined over the data axes (its gather-once layout, each
    process keeping its model part), its gradient summed back onto the
    block in the backward; a plain tensor as it is. Inside ``released``
    the joined tensor is not kept for the backward."""
    if not isinstance(x, Block):
        return x
    full = _Join.apply(x.block, x.sharding)
    if _RELEASE and full.untyped_storage()._cdata != \
            x.block.untyped_storage()._cdata:
        _RELEASE[-1][full.untyped_storage()._cdata] = (weakref.ref(full), x)
    return full


class _Refetch(NamedTuple):
    part: Block
    size: tuple
    stride: tuple
    offset: int


@contextlib.contextmanager
def released():
    """A scope (one layer's forward) whose joined parameters live only
    while it runs, as FSDP's: a tensor the backward saves that is one of
    them (or a view of one) is kept as its block and joined again when
    the backward reads it. A layer that is recomputed in the backward
    (``torch.utils.checkpoint``) joins its parameters again anyway.
    Without a real mesh it does nothing."""
    if rules.active_device_mesh() is None:
        yield
        return
    live: Dict[int, tuple] = {}

    def pack(t):
        try:           # by storage (a meta storage has no address)
            ent = live.get(t.untyped_storage()._cdata)
        except RuntimeError:         # a tensor without storage
            return t
        if ent is None or ent[0]() is None:
            return t
        return _Refetch(ent[1], tuple(t.size()), tuple(t.stride()),
                        t.storage_offset())

    def unpack(x):
        if not isinstance(x, _Refetch):
            return x
        with torch.no_grad():
            full = gather_params(x.part.block, x.part.sharding)
        return full.as_strided(x.size, x.stride, x.offset)

    _RELEASE.append(live)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        _RELEASE.pop()


class Joined(Mapping):
    """Placed parameters as a loss reads them on a train mesh: this
    process's blocks and their shardings. ``p[k]`` is leaf k joined over
    the data axes at the access (``joined``; not kept: each access joins
    again); ``lazy`` and ``lazy_layers`` hand the block, or each layer's
    slice of a stacked block, on unjoined, for the model to join where a
    layer uses it. No process holds the whole tree joined."""

    def __init__(self, blocks: Dict[str, torch.Tensor],
                 shardings: Dict[str, object]):
        self.blocks, self.shardings = blocks, shardings

    def __getitem__(self, k):
        return joined(self.lazy(k))

    def __iter__(self):
        return iter(self.blocks)

    def __len__(self):
        return len(self.blocks)

    def __contains__(self, k):
        return k in self.blocks

    def lazy(self, k) -> Block:
        return Block(self.blocks[k], self.shardings[k])

    def lazy_layers(self, k) -> list:
        sh = self.shardings[k]
        sh = type(sh)(sh.mesh, tuple(sh.spec[1:]))
        return [Block(b, sh) for b in self.blocks[k].unbind(0)]


def lazy(params, k):
    """Leaf k of a loss's parameters: a ``Block`` of a ``Joined``, else
    the tensor."""
    return params.lazy(k) if isinstance(params, Joined) else params[k]


def lazy_layers(params, k) -> list:
    """The layers of the stacked leaf k: ``Block``s of a ``Joined``, else
    the tensor's slices."""
    return (params.lazy_layers(k) if isinstance(params, Joined)
            else list(params[k].unbind(0)))


class RowBlock(NamedTuple):
    """A table whose rows the model axis of ``mesh`` splits, as a loss
    reads it: this process's ``block`` of rows and the whole table's
    ``rows``. ``shape`` is the whole table's, as a DTensor's is, and
    ``recsys.embedding_lookup`` looks it up row-parallel
    (``row_parallel_lookup``) on any mesh, a ``MetaMesh`` included."""
    block: torch.Tensor
    device_mesh: object
    rows: int

    @property
    def shape(self):
        return torch.Size((self.rows,) + tuple(self.block.shape[1:]))

    def to_local(self) -> torch.Tensor:
        return self.block


def row_parallel_lookup(block: torch.Tensor, ids: torch.Tensor, axis: Axis,
                        fetch) -> torch.Tensor:
    """The rows ``ids`` (within the table) of a table whose rows ``axis``
    splits, ``block`` this process's range of them: each process fetches
    the ids in its range (``fetch(block, local ids)``), -0.0 for the rest,
    and the axis adds the parts (the reference's masked gather and
    ``psum``). Every term but one is -0.0, the sum's neutral element, so
    the result is the row's bits, -0.0 included."""
    n = block.shape[0]
    rel = ids.long() - axis.index * n
    mine = (rel >= 0) & (rel < n)
    got = fetch(block, rel.clamp(0, n - 1))
    mine = mine.reshape(*mine.shape, *(1,) * (got.dim() - mine.dim()))
    return tp_reduce(torch.where(mine, got, -0.0), axis)


def replicas(sharding) -> int:
    """How many processes hold each block of a leaf: the sizes of the
    mesh axes its spec does not name."""
    named = {a for e in sharding.spec for a in rules._axes(e)}
    n = 1
    for a, size in rules.mesh_sizes(sharding.mesh).items():
        n *= 1 if a in named else size
    return n


def mesh_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over every process of ``mesh`` (the whole
    world: a train mesh holds every process of the group)."""
    if not x.is_meta and mesh.size() != dist.get_world_size():
        raise ValueError(f"mesh of {mesh.size()} processes in a world of "
                         f"{dist.get_world_size()}")
    return _all_reduce(x, None) if mesh.size() > 1 else x
