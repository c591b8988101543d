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
"""
from __future__ import annotations

import contextlib
import weakref
from collections.abc import Mapping
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding import rules


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
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The axis's parts of ``x`` joined along ``dim`` in axis order."""
    if axis.size == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((axis.size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=axis.group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The axis's sum of ``x``, this process's part of ``dim`` of it."""
    if axis.size == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // axis.size,) + tuple(src.shape[1:]))
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
    if _RELEASE and full.untyped_storage().data_ptr() != \
            x.block.untyped_storage().data_ptr():
        _RELEASE[-1][full.untyped_storage().data_ptr()] = (
            weakref.ref(full), x)
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
        try:
            ent = live.get(t.untyped_storage().data_ptr())
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
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"mesh of {mesh.size()} processes in a world of "
                         f"{dist.get_world_size()}")
    return _all_reduce(x, None) if mesh.size() > 1 else x
