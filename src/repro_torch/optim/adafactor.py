"""Adafactor [arXiv:1804.04235]: a factored second moment, O(n + m) state
for an (n, m) matrix, and RMS update clipping. Counterpart of
``repro/optim/adafactor.py``. A leaf of two or more dims is factored over
its last two (a stacked ``layers/*`` leaf keeps its layer axis in the row
moment, as in the reference); the RMS clip is over the whole leaf. On a
train mesh the row and column means and the RMS are the whole leaf's,
added over the processes that split the dims they average."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.adamw import _count
from repro_torch.optim.common import (Optimizer, Params, _is_placed, like,
                                      local, mean, resolve_lr)


class AdafactorState(NamedTuple):
    count: torch.Tensor
    vr: Params     # row second moment (the full v for a leaf under 2-D)
    vc: Params     # column second moment (zeros of (1,) under 2-D)


def _factored_placements(p, drop: int):
    """A factored moment's placements: ``p``'s, with the mesh dimensions
    that split ``p``'s dim ``drop`` (the one the moment averages away)
    replicated and the dims after it moved down one (``opt_state_specs``'
    rule)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pl in p.placements:
        if not pl.is_shard():
            out.append(pl)
        elif pl.dim % p.ndim == drop:
            out.append(Replicate())
        else:
            d = pl.dim % p.ndim
            out.append(Shard(d - 1 if d > drop else d))
    return out


def _factored(block: torch.Tensor, p: torch.Tensor, drop: int):
    """A factored moment's block placed by ``_factored_placements``."""
    if not _is_placed(p):
        return block
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(block, p.device_mesh,
                              _factored_placements(p, drop),
                              run_check=False)


def adafactor(lr=1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    def init(params: Params) -> AdafactorState:
        vr, vc = {}, {}
        for k, p in params.items():
            b = local(p)
            f32 = dict(dtype=torch.float32, device=b.device)
            if p.dim() >= 2:
                vr[k] = _factored(torch.zeros(b.shape[:-1], **f32), p,
                                  p.dim() - 1)
                vc[k] = _factored(
                    torch.zeros(b.shape[:-2] + b.shape[-1:], **f32), p,
                    p.dim() - 2)
            else:
                vr[k] = like(torch.zeros(b.shape, **f32), p)
                vc[k] = _factored(torch.zeros((1,), **f32), p, 0)
        return AdafactorState(_count(params), vr, vc)

    def update(grads: Params, state: AdafactorState, params: Params):
        c = local(state.count) + 1
        lr_t = resolve_lr(lr, c)
        beta = 1.0 - c.float() ** -decay
        updates, vr, vc = {}, {}, {}
        for k, gk in grads.items():
            g = local(gk).float()
            g2 = g * g + eps
            svr, svc = local(state.vr[k]), local(state.vc[k])
            if g.dim() >= 2:
                vr2 = beta * svr + (1 - beta) * mean(g2, gk, -1)
                vc2 = beta * svc + (1 - beta) * mean(g2, gk, -2)
                denom = (vr2[..., None] / torch.clamp(
                    mean(vr2, state.vr[k], -1, keepdim=True)[..., None],
                    min=eps)) * vc2[..., None, :]
                u = g * torch.rsqrt(torch.clamp(denom, min=eps))
            else:
                vr2 = beta * svr + (1 - beta) * g2
                vc2 = svc
                u = g * torch.rsqrt(torch.clamp(vr2, min=eps))
            rms = torch.sqrt(mean(u * u, gk) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            updates[k] = like(-lr_t * u, gk)
            vr[k], vc[k] = like(vr2, state.vr[k]), like(vc2, state.vc[k])
        return updates, AdafactorState(like(c, state.count), vr, vc)

    return Optimizer(init, update)
