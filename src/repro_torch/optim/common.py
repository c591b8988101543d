"""Shared optimizer plumbing. Counterpart of ``repro/optim/common.py``.

Parameters, gradients and updates are flat dicts of tensors keyed by the
reference's checkpoint paths (``embed``, ``layers/attn/wq``,
``prefix/0/mlp/w_up``, ...; the ``layers/*`` leaves stacked over a leading
layer axis), so each leaf is the
reference's leaf, shapes included, and a checkpoint in the JAX key layout
needs no conversion. Every op runs on the leaves' device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Any]     # (grads, state, params) -> (updates, state)


def _path_key(key: str):
    """A key's path parts, a list index (all digits) as its number."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in key.split("/"))


def leaf_order(tree: Params) -> List[str]:
    """The keys in the reference's leaf order: ``jax.tree`` flattens a
    nested dict in sorted key order at each level and a list (an MoE
    LM's ``prefix/<i>/...``) in index order, so ``prefix/2`` comes before
    ``prefix/10``."""
    return sorted(tree, key=_path_key)


def params_from_numpy(flat: Dict[str, Any], shapes: Dict[str, Tuple[int, ...]],
                      *, name: str, device) -> Params:
    """Flat, path-keyed numpy leaves (the reference's checkpoint form) as
    f32 tensors on ``device``; their keys and shapes must be ``shapes``'."""
    import numpy as np
    if set(flat) != set(shapes):
        raise KeyError(f"{name}: checkpoint keys differ: missing "
                       f"{sorted(set(shapes) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(shapes))}")
    out = {}
    for k, shape in shapes.items():
        a = np.asarray(flat[k])
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{k}: want {tuple(shape)}, got {a.shape}")
        out[k] = torch.from_numpy(a.astype(np.float32)).to(device)
    return out


# -- placed leaves -----------------------------------------------------------
# A leaf placed on a train mesh is a DTensor (``sharding.rules.place``).
# The optimizers work on each process's block (``local``) and give every
# result its leaf's placement back (``like``); only whole-leaf reductions
# (``global_norm``, Adafactor's means) cross processes.

def _is_placed(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This process's block of a placed leaf; a plain tensor as it is."""
    return t.to_local() if _is_placed(t) else t


def like(block: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``block`` placed as ``ref`` is (a plain tensor when ``ref`` is)."""
    if not _is_placed(ref):
        return block
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(block, ref.device_mesh, ref.placements,
                              run_check=False)


def _shard_groups(ref, dims) -> list:
    """The process groups of the mesh dimensions that split any of
    ``dims`` of the placed leaf ``ref``."""
    out = []
    for i, pl in enumerate(ref.placements):
        if pl.is_shard() and pl.dim % ref.ndim in dims:
            out.append(ref.device_mesh.get_group(i))
    return out


def mean(x: torch.Tensor, ref: torch.Tensor, dim=None,
         keepdim: bool = False) -> torch.Tensor:
    """The mean of the block ``x`` of a leaf placed as ``ref`` (of the same
    rank) over ``dim`` (every dim if None), taken over the whole leaf: the
    block's sum added over the processes that split those dims, over
    their whole size. A plain ``ref`` takes ``x.mean`` itself."""
    if not _is_placed(ref):
        return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
    import torch.distributed as dist
    dims = tuple(range(ref.ndim)) if dim is None else tuple(
        d % ref.ndim for d in ((dim,) if isinstance(dim, int) else dim))
    s = x.sum(dim=dims, keepdim=keepdim)
    for group in _shard_groups(ref, dims):
        dist.all_reduce(s, group=group)
    n = 1
    for d in dims:
        n *= ref.shape[d]
    return s / n


def apply_updates(params: Params, updates: Params) -> Params:
    """An f32 add, then a cast back to each parameter's dtype."""
    return {k: like((local(p).float() + local(updates[k])).to(p.dtype), p)
            for k, p in params.items()}


def global_norm(tree: Params, shardings=None) -> torch.Tensor:
    """sqrt of the per-leaf f32 sums of squares, added in leaf order. Of
    a mesh's leaves each process sums its block, the blocks' sums are
    added over the mesh in one collective (each block counted once), and
    the result is the same on every process. The leaves are placed, or
    plain blocks that ``shardings`` ({key: NamedSharding}) places."""
    keys = leaf_order(tree)
    sums = [local(tree[k]).float().square().sum() for k in keys]
    if shardings is None and any(_is_placed(tree[k]) for k in keys):
        from repro_torch.sharding import rules
        shardings = {k: rules.sharding_of(tree[k]) for k in keys
                     if _is_placed(tree[k])}
    if shardings and keys:
        from repro_torch.sharding import spmd
        mesh = next(iter(shardings.values())).mesh
        reps = torch.tensor(
            [spmd.replicas(shardings[k]) if k in shardings else mesh.size()
             for k in keys], dtype=torch.float32, device=sums[0].device)
        sums = list(spmd.mesh_sum(torch.stack(sums) / reps,
                                  mesh).unbind(0))
    tot = torch.zeros((), dtype=torch.float32,
                      device=sums[0].device if keys else None)
    for s in sums:
        tot = tot + s
    return torch.sqrt(tot)


def clip_by_global_norm(grads: Params, max_norm: float, shardings=None
                        ) -> Tuple[Params, torch.Tensor]:
    n = global_norm(grads, shardings)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return {k: like(local(g) * scale.to(g.dtype), g)
            for k, g in grads.items()}, n


def resolve_lr(lr, count: torch.Tensor) -> torch.Tensor:
    """The step's learning rate as an f32 tensor on ``count``'s device:
    ``lr(count)`` for a schedule, else the constant."""
    return lr(count) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=count.device)
