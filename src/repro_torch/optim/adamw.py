"""AdamW and SGD with momentum, with the reference's formulas
(``repro/optim/adamw.py``), not ``torch.optim``'s: eps is added to the
root of the bias-corrected second moment, weight decay is ``+ lr * wd * p``
on the step, the bias corrections ``1 - b ** count`` are f32 tensors, and
the moments are kept in ``state_dtype``."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.common import Optimizer, Params, resolve_lr


class AdamWState(NamedTuple):
    count: torch.Tensor
    m: Params
    v: Params


def _count(params: Params) -> torch.Tensor:
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(lr=1e-3, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params: Params) -> AdamWState:
        def z(p):
            return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return AdamWState(_count(params), {k: z(p) for k, p in params.items()},
                          {k: z(p) for k, p in params.items()})

    def update(grads: Params, state: AdamWState, params: Params):
        c = state.count + 1
        lr_t = resolve_lr(lr, c)
        bc1 = 1.0 - b1 ** c.float()
        bc2 = 1.0 - b2 ** c.float()
        updates, m, v = {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            m2 = b1 * state.m[k].float() + (1 - b1) * g
            v2 = b2 * state.v[k].float() + (1 - b2) * g * g
            step = lr_t * (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            if weight_decay:
                step = step + lr_t * weight_decay * params[k].float()
            updates[k] = -step
            m[k], v[k] = m2.to(state_dtype), v2.to(state_dtype)
        return updates, AdamWState(c, m, v)

    return Optimizer(init, update)


class MomentumState(NamedTuple):
    count: torch.Tensor
    mom: Params


def sgd_momentum(lr=1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params: Params) -> MomentumState:
        return MomentumState(_count(params), {
            k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()})

    def update(grads: Params, state: MomentumState, params: Params):
        c = state.count + 1
        lr_t = resolve_lr(lr, c)
        mom = {k: momentum * state.mom[k] + g.float()
               for k, g in grads.items()}
        return {k: -lr_t * b for k, b in mom.items()}, MomentumState(c, mom)

    return Optimizer(init, update)
