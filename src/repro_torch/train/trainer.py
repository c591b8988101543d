"""The training loop's substrate: a train step with optional gradient
accumulation (microbatches), metrics, and a pluggable loss and optimizer.
Counterpart of ``repro/train/trainer.py``.

Parameters are a flat dict of tensors in the reference's checkpoint form
(``transformer.stack_params``, ``gnn.init_gat``, ``recsys.INIT``); the step makes
them leaves that require grad, takes ``torch.autograd.grad`` of the loss,
and updates them without gradients. A step's metrics stay on the device:
reading one (``float(m["loss"])``) waits for it.

On a train mesh (one process a card, ``launch.mesh.make_host_mesh``) the
state is placed before the step, as the reference's ``jit(step,
in_shardings=...)`` takes it: ``place_params`` lays the parameters out by
their family's rules (DTensors, each process holding its block),
``init_train_state`` then places the optimizer state as
``rules.opt_state_specs`` says, and ``place_batch`` splits the batch over
the data axes. The step runs the loss under ``activation_mesh`` of the
mesh (the models' tensor and expert parallelism) on a ``spmd.Joined``
view of the blocks: each parameter, or each layer's slice of a stacked
one, is joined over the data axes where the model uses it (each process
keeping its model part) and released after that layer, and its gradient
is summed over the data axes onto its own block as soon as the backward
makes it (a reduce-scatter); no process holds the whole parameter tree,
or the whole gradient tree, joined. The reported loss is the mean over
the data processes, the same on every process.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.optim.common import Params, _is_placed, like, local
from repro_torch.sharding import rules, spmd


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: torch.Tensor


def init_train_state(params: Params, optimizer: Optimizer) -> TrainState:
    """The state of ``params``; placed parameters (``place_params``) give
    an optimizer state placed by ``rules.opt_state_specs`` and a step
    replicated over the mesh."""
    opt_state = optimizer.init(params)
    return TrainState(params, opt_state, like(
        torch.zeros((), dtype=torch.int32,
                    device=local(opt_state.count).device), opt_state.count))


FAMILY_SPECS = {"lm": rules.lm_specs, "recsys": rules.recsys_specs,
                "gnn": rules.gnn_specs}


def param_shardings(params, mesh, family: str):
    """{path: NamedSharding} of a family's parameters on ``mesh``."""
    return FAMILY_SPECS[family](params, mesh)


def state_shardings(state: TrainState, mesh, family: str) -> TrainState:
    """A ``TrainState`` of ``NamedSharding``s: the parameters by the
    family's rules, the optimizer state by ``rules.opt_state_specs``, the
    step replicated (the reference's ``_lm_state_shardings``)."""
    ps = param_shardings(state.params, mesh, family)
    return TrainState(ps, rules.opt_state_specs(state.opt_state, ps, mesh),
                      rules.NamedSharding(mesh, ()))


def place_params(params: Params, mesh, family: str) -> Params:
    """Whole parameters (the same on every process) placed on ``mesh`` by
    the family's rules: each process keeps its block."""
    sh = param_shardings(params, mesh, family)
    return {k: rules.place(p, sh[k]) for k, p in params.items()}


def batch_sharding(mesh) -> rules.NamedSharding:
    """The batch's ``P(dp, None)``: rows split over the data axes."""
    dp = rules.dp_axes(mesh)
    return rules.NamedSharding(mesh, (dp if len(dp) > 1 else dp[0], None))


def _map(fn, tree):
    """``fn`` over the tensor leaves of a batch: a tensor, or a dict,
    tuple or NamedTuple of them (nested)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def place_batch(batch, mesh, rows: Optional[int] = None):
    """A whole batch (the same on every process; a tensor or a dict,
    tuple or NamedTuple of them) split over the data axes by rows: every
    leaf whose leading dim is ``rows`` (default: the first leaf's), each
    process keeping its rows; other leaves (BERT4Rec's shared negatives)
    stay whole on every process."""
    sh = batch_sharding(mesh)
    if rows is None:
        leaves = []
        _map(leaves.append, batch)
        rows = leaves[0].shape[0]
    return _map(lambda x: rules.place(x, sh)
                if x.dim() and x.shape[0] == rows else x, batch)


def _placed(block: torch.Tensor, sharding: rules.NamedSharding):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(block, sharding.mesh,
                              rules.placements(sharding), run_check=False)


def gather_once(params: Params) -> Params:
    """Placed parameters joined over the data axes: the gather-once layout
    (``rules.drop_fsdp``), for ``make_train_step``'s ``param_resharding``
    on a mesh."""
    out = {}
    for k, p in params.items():
        sh = rules.sharding_of(p)
        out[k] = _placed(spmd.gather_params(local(p), sh),
                         rules.drop_fsdp(sh))
    return out


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


def _accumulate(loss_fn: Callable, params: Params, batch, microbatches: int
                ) -> Tuple[torch.Tensor, Params]:
    """(loss, gradients) at ``params``: of the whole batch, or with
    microbatches > 1 of each part of its leading axis, the losses and
    gradients added in f32 in order and scaled by 1 / microbatches."""
    if microbatches == 1:
        return _value_and_grad(loss_fn, params, batch)
    tot = acc = None
    for micro in _split(batch, microbatches):
        loss, grads = _value_and_grad(loss_fn, params, micro)
        grads = {k: g.float() for k, g in grads.items()}
        tot = loss.float() if tot is None else tot + loss
        acc = grads if acc is None else {k: a + grads[k]
                                         for k, a in acc.items()}
    scale = 1.0 / microbatches
    return tot * scale, {k: g * scale for k, g in acc.items()}


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    grad_clip: float = 1.0, microbatches: int = 1,
                    param_resharding: Optional[Callable] = None,
                    shardings=None):
    """loss_fn(params, batch) -> scalar. Returns step(state, batch) ->
    (state, metrics). With microbatches > 1 the batch's leading axis is
    split, and the losses and gradients are added in f32 in order, then
    scaled by 1 / microbatches. ``param_resharding`` (optional) is
    applied to the parameters ONCE a step, before the microbatch loop,
    and only with microbatches > 1, where the reference applies it (its
    gather-once layout); the gradients are taken at what it returns and
    the update applies to the state's parameters. ``shardings`` ({key:
    NamedSharding} on one mesh) makes it the step of ONE process of that
    mesh on its blocks as plain tensors (the state's parameters and
    optimizer state, ``batch`` its rows): the placed step's work
    (``_block_grads``, the global norm over the mesh's blocks). The dry
    run reckons a mesh cell's process so under a ``spmd.MetaMesh``, where
    every collective takes its meta route."""
    if shardings is not None and param_resharding is not None:
        raise ValueError("make_train_step: shardings= takes no "
                         "param_resharding")

    def step(state: TrainState, batch) -> Tuple[TrainState,
                                                Dict[str, torch.Tensor]]:
        once = param_resharding is not None and microbatches > 1
        if shardings is not None:
            loss, grads = _block_grads(loss_fn, state.params, shardings,
                                       batch, microbatches)
        elif _is_placed(next(iter(state.params.values()))):
            loss, grads = _mesh_grads(loss_fn, state.params, batch,
                                      microbatches,
                                      param_resharding if once else None)
        else:
            loss, grads = _accumulate(
                loss_fn, param_resharding(state.params) if once
                else state.params, batch, microbatches)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, grad_clip, shardings)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            params = apply_updates(state.params, updates)
        nxt = like(local(state.step) + 1, state.step)
        return (TrainState(params, opt_state, nxt),
                {"loss": loss, "grad_norm": gnorm, "step": local(nxt)})

    return step


def _block_grads(loss_fn: Callable, blocks: Params, shard, batch,
                 microbatches: int) -> Tuple[torch.Tensor, Params]:
    """(loss, gradients) of this process's ``blocks`` (placed as ``shard``
    says on its mesh) and batch rows: each microbatch's loss under the
    mesh on a ``spmd.Joined`` view of the blocks, the gradients summed
    over the data axes onto the blocks as the backward makes them; loss
    and gradients scaled to the mean over the data processes."""
    mesh = next(iter(shard.values())).mesh
    dps = [spmd.Axis(mesh, a) for a in rules.dp_axes(mesh)]
    with rules.activation_mesh(mesh):
        loss, grads = _accumulate(
            lambda p, b: loss_fn(spmd.Joined(p, shard), b), blocks, batch,
            microbatches)
    n_dp = 1
    for a in dps:
        loss = spmd.all_reduce(loss.float(), a)
        n_dp *= a.size
    scale = 1.0 / n_dp
    return loss * scale, {k: g * scale for k, g in grads.items()}


def _mesh_grads(loss_fn: Callable, params: Params, batch, microbatches: int,
                resharding: Optional[Callable]):
    """(loss, gradients placed as the parameters) of a step on the mesh of
    the placed ``params``. Each microbatch's loss runs on this process's
    rows of the batch under the mesh, reading the parameters as a
    ``spmd.Joined``: each leaf (each layer's slice of a stacked one) is
    joined over the data axes where the model uses it and released after
    it, and its gradient summed over the data axes onto its block as the
    backward makes it (a reduce-scatter), so no process holds the whole
    tree joined. With ``resharding`` (the gather-once layout, microbatches
    > 1) the joined parameters are held over the microbatch loop, as the
    reference's layout says, and the gradients summed onto the blocks
    once after it. The gradients and the loss are scaled to the mean
    over the data processes."""
    shard = {k: rules.sharding_of(p) for k, p in params.items()}
    mesh = next(iter(shard.values())).mesh
    batch = _map(local, batch)
    if resharding is None:
        loss, grads = _block_grads(loss_fn, {k: local(p) for k, p in
                                             params.items()}, shard, batch,
                                   microbatches)
        return loss, {k: like(g, params[k]) for k, g in grads.items()}
    dps = [spmd.Axis(mesh, a) for a in rules.dp_axes(mesh)]
    n_dp = 1
    for a in dps:
        n_dp *= a.size
    with rules.activation_mesh(mesh):
        held = {k: local(p) for k, p in resharding(params).items()}
        loss, grads = _accumulate(loss_fn, held, batch, microbatches)
        grads = {k: spmd.reduce_grad(g, shard[k]) for k, g in grads.items()}
    for a in dps:
        loss = spmd.all_reduce(loss.float(), a)
    scale = 1.0 / n_dp
    return loss * scale, {k: like(g * scale, params[k])
                          for k, g in grads.items()}
