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


def apply_updates(params: Params, updates: Params) -> Params:
    """An f32 add, then a cast back to each parameter's dtype."""
    return {k: (p.float() + updates[k]).to(p.dtype)
            for k, p in params.items()}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the per-leaf f32 sums of squares, added in leaf order."""
    keys = leaf_order(tree)
    tot = torch.zeros((), dtype=torch.float32,
                      device=tree[keys[0]].device if keys else None)
    for k in keys:
        tot = tot + tree[k].float().square().sum()
    return torch.sqrt(tot)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, n


def resolve_lr(lr, count: torch.Tensor) -> torch.Tensor:
    """The step's learning rate as an f32 tensor on ``count``'s device:
    ``lr(count)`` for a schedule, else the constant."""
    return lr(count) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=count.device)
