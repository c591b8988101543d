"""AdamW and SGD with momentum, with the reference's formulas
(``repro/optim/adamw.py``), not ``torch.optim``'s: eps is added to the
root of the bias-corrected second moment, weight decay is ``+ lr * wd * p``
on the step, the bias corrections ``1 - b ** count`` are f32 tensors, and
the moments are kept in ``state_dtype``. On a train mesh every leaf's
update is its own block's, placed as the leaf is."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.common import (Optimizer, Params, _is_placed, like,
                                      local, resolve_lr)


class AdamWState(NamedTuple):
    count: torch.Tensor
    m: Params
    v: Params


def _count(params: Params) -> torch.Tensor:
    """The step count, 0: on a train mesh replicated on every process."""
    first = next(iter(params.values()), None)
    dev = None if first is None else local(first).device
    c = torch.zeros((), dtype=torch.int32, device=dev)
    if first is None or not _is_placed(first):
        return c
    from torch.distributed.tensor import DTensor, Replicate
    mesh = first.device_mesh
    return DTensor.from_local(c, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _zeros(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros shaped and placed as ``p`` (each process its block)."""
    return like(torch.zeros(local(p).shape, dtype=dtype,
                            device=local(p).device), p)


def adamw(lr=1e-3, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params: Params) -> AdamWState:
        def zeros():
            return {k: _zeros(p, state_dtype) for k, p in params.items()}
        return AdamWState(_count(params), zeros(), zeros())

    def update(grads: Params, state: AdamWState, params: Params):
        c = local(state.count) + 1
        lr_t = resolve_lr(lr, c)
        bc1 = 1.0 - b1 ** c.float()
        bc2 = 1.0 - b2 ** c.float()
        updates, m, v = {}, {}, {}
        for k, gk in grads.items():
            g = local(gk).float()
            m2 = b1 * local(state.m[k]).float() + (1 - b1) * g
            v2 = b2 * local(state.v[k]).float() + (1 - b2) * g * g
            step = lr_t * (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            if weight_decay:
                step = step + lr_t * weight_decay * local(params[k]).float()
            updates[k] = like(-step, gk)
            m[k] = like(m2.to(state_dtype), state.m[k])
            v[k] = like(v2.to(state_dtype), state.v[k])
        return updates, AdamWState(like(c, state.count), m, v)

    return Optimizer(init, update)


class MomentumState(NamedTuple):
    count: torch.Tensor
    mom: Params


def sgd_momentum(lr=1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params: Params) -> MomentumState:
        return MomentumState(_count(params), {
            k: _zeros(p, torch.float32) for k, p in params.items()})

    def update(grads: Params, state: MomentumState, params: Params):
        c = local(state.count) + 1
        lr_t = resolve_lr(lr, c)
        mom = {k: momentum * local(state.mom[k]) + local(g).float()
               for k, g in grads.items()}
        return ({k: like(-lr_t * b, grads[k]) for k, b in mom.items()},
                MomentumState(like(c, state.count),
                              {k: like(b, state.mom[k])
                               for k, b in mom.items()}))

    return Optimizer(init, update)
