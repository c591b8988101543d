"""The training loop's substrate: a train step with optional gradient
accumulation (microbatches), metrics, and a pluggable loss and optimizer.
Counterpart of ``repro/train/trainer.py``.

Parameters are a flat dict of tensors in the reference's checkpoint form
(``transformer.stack_params``, ``gnn.init_gat``, ``recsys.INIT``); the step makes
them leaves that require grad, takes ``torch.autograd.grad`` of the loss,
and updates them without gradients. A step's metrics stay on the device:
reading one (``float(m["loss"])``) waits for it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.optim.common import Params


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: torch.Tensor


def init_train_state(params: Params, optimizer: Optimizer) -> TrainState:
    dev = next(iter(params.values())).device
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def _value_and_grad(loss_fn: Callable, params: Params, batch
                    ) -> Tuple[torch.Tensor, Params]:
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(leaves.items(), grads)}


def _split(batch, microbatches: int):
    """The batch's leading axis split into ``microbatches`` parts: a list
    of batches of the same structure (a tensor, or a tuple of them)."""
    def parts(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{microbatches} microbatches")
        return x.reshape(microbatches, b // microbatches, *x.shape[1:])
    if isinstance(batch, torch.Tensor):
        return list(parts(batch))
    return list(zip(*(parts(x) for x in batch)))


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    grad_clip: float = 1.0, microbatches: int = 1,
                    param_resharding: Optional[Callable] = None):
    """loss_fn(params, batch) -> scalar. Returns step(state, batch) ->
    (state, metrics). With microbatches > 1 the batch's leading axis is
    split, and the losses and gradients are added in f32 in order, then
    scaled by 1 / microbatches. ``param_resharding`` (optional) is
    applied to the parameters ONCE a step, before the microbatch loop,
    and only with microbatches > 1, where the reference applies it (its
    gather-once layout); the gradients are taken at what it returns and
    the update applies to the state's parameters."""

    def accumulated(params: Params, batch) -> Tuple[torch.Tensor, Params]:
        if param_resharding is not None:
            params = param_resharding(params)
        tot = acc = None
        for micro in _split(batch, microbatches):
            loss, grads = _value_and_grad(loss_fn, params, micro)
            if acc is None:
                tot = torch.zeros((), dtype=torch.float32,
                                  device=loss.device)
                acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                       for k, p in params.items()}
            tot = tot + loss
            acc = {k: a + grads[k].float() for k, a in acc.items()}
        scale = 1.0 / microbatches
        return tot * scale, {k: g * scale for k, g in acc.items()}

    def step(state: TrainState, batch) -> Tuple[TrainState,
                                                Dict[str, torch.Tensor]]:
        loss, grads = (_value_and_grad(loss_fn, state.params, batch)
                       if microbatches == 1 else
                       accumulated(state.params, batch))
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            params = apply_updates(state.params, updates)
        return (TrainState(params, opt_state, state.step + 1),
                {"loss": loss, "grad_norm": gnorm, "step": state.step + 1})

    return step
