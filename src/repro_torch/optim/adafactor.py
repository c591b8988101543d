"""Adafactor [arXiv:1804.04235]: a factored second moment, O(n + m) state
for an (n, m) matrix, and RMS update clipping. Counterpart of
``repro/optim/adafactor.py``. A leaf of two or more dims is factored over
its last two (a stacked ``layers/*`` leaf keeps its layer axis in the row
moment, as in the reference); the RMS clip is over the whole leaf."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.adamw import _count
from repro_torch.optim.common import Optimizer, Params, resolve_lr


class AdafactorState(NamedTuple):
    count: torch.Tensor
    vr: Params     # row second moment (the full v for a leaf under 2-D)
    vc: Params     # column second moment (zeros of (1,) under 2-D)


def adafactor(lr=1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    def init(params: Params) -> AdafactorState:
        vr, vc = {}, {}
        for k, p in params.items():
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                vr[k] = torch.zeros(p.shape[:-1], **f32)
                vc[k] = torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)
            else:
                vr[k] = torch.zeros(p.shape, **f32)
                vc[k] = torch.zeros((1,), **f32)
        return AdafactorState(_count(params), vr, vc)

    def update(grads: Params, state: AdafactorState, params: Params):
        c = state.count + 1
        lr_t = resolve_lr(lr, c)
        beta = 1.0 - c.float() ** -decay
        updates, vr, vc = {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            g2 = g * g + eps
            if g.dim() >= 2:
                vr2 = beta * state.vr[k] + (1 - beta) * g2.mean(dim=-1)
                vc2 = beta * state.vc[k] + (1 - beta) * g2.mean(dim=-2)
                denom = (vr2[..., None] / torch.clamp(
                    vr2.mean(dim=-1, keepdim=True)[..., None], min=eps)) \
                    * vc2[..., None, :]
                u = g * torch.rsqrt(torch.clamp(denom, min=eps))
            else:
                vr2 = beta * state.vr[k] + (1 - beta) * g2
                vc2 = state.vc[k]
                u = g * torch.rsqrt(torch.clamp(vr2, min=eps))
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            updates[k], vr[k], vc[k] = -lr_t * u, vr2, vc2
        return updates, AdafactorState(c, vr, vc)

    return Optimizer(init, update)
