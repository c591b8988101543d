"""Fault tolerance. Counterpart of ``repro/train/fault.py``:

1. **Checkpoint/restart**: ``run_with_failures`` drives a step function
   with injected failures; on a failure it restores the last checkpoint
   and replays. With deterministic steps the result equals a run without
   failures bit for bit.
2. **Crawler domain rebalance (C4)**: ``heal_crawler`` moves a dead
   shard's domains to the survivors and migrates their rows; ``revive``
   brings shards back.
3. **Elastic re-mesh**: checkpoints are mesh-free, and ``reshard``
   places a tree on a train mesh of any shape by specs
   (``checkpoint.restore(..., shardings=)`` does it leaf by leaf), so a
   state saved under (2, 2) steps on under (4, 1) or (1, 4). On one card
   (a device in the mesh's place) every leaf stays whole, and the next
   step runs under ``sharding.rules.activation_mesh`` of the new shape
   (its MoE layers route in that shape's groups).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import crawler as CR
from repro_torch.core import partitioner as PT
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class FailurePlan:
    """Deterministic failure schedule: steps at which the 'cluster' dies
    after computing (but before checkpointing) that step."""
    fail_at: Tuple[int, ...] = ()


def run_with_failures(step_fn: Callable, state, batches: Iterable, *,
                      ckpt_dir: str, ckpt_every: int = 10,
                      plan: FailurePlan = FailurePlan(),
                      state_step: Callable = lambda s: int(s.step)) -> Any:
    """Drive step_fn(state, batch) -> (state, metrics) with failure
    injection and restart. Batches must be re-iterable from any step index
    (a list or a factory) for deterministic replay."""
    batches = list(batches)
    ckpt.save(ckpt_dir, state_step(state), state)
    failed = set(plan.fail_at)
    i = state_step(state)
    while i < len(batches):
        state, _ = step_fn(state, batches[i])
        i += 1
        if i in failed:
            failed.discard(i)          # each failure fires once
            # crash before persisting: roll back to the last checkpoint
            state = ckpt.restore(ckpt_dir, state)
            i = state_step(state)
            continue
        if i % ckpt_every == 0:
            ckpt.save(ckpt_dir, i, state)
    return state


def _replicated(spec) -> bool:
    """A reference spec that places a leaf whole: None, or a
    ``PartitionSpec`` (any tuple) of no axis."""
    return spec is None or (isinstance(spec, tuple)
                            and all(a is None for a in spec))


def _walk(tree, spec_tree, put):
    """``put(leaf, spec)`` over a tree (nested dicts, lists, tuples and
    NamedTuples) and a spec tree of the same structure (or None)."""
    if isinstance(tree, dict):
        return {k: _walk(v, None if spec_tree is None else spec_tree[k], put)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        specs = [None] * len(tree) if spec_tree is None else spec_tree
        items = [_walk(v, s, put) for v, s in zip(tree, specs)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return put(tree, spec_tree)


def reshard(tree, mesh, spec_tree=None):
    """Place every tensor leaf of ``tree`` (a restored state: nested dicts,
    lists, tuples and NamedTuples) onto ``mesh`` with the specs of
    ``spec_tree`` (the same structure; a tuple spec, a
    ``rules.NamedSharding`` whose spec is taken, or None = replicate):
    the elastic re-mesh primitive, for a mesh of any shape. A leaf placed
    on another mesh is joined whole first. ``mesh`` may also be a device
    (the reference's signature on one card), where every leaf stays
    whole: a spec that names a mesh axis raises there."""
    from repro_torch.sharding import rules
    if not rules._is_device_mesh(mesh):
        dev = torch.device(mesh)

        def put_one(x, spec):
            if not _replicated(getattr(spec, "spec", spec)):
                raise ValueError(f"reshard: spec {spec!r} splits a leaf "
                                 f"over a mesh axis, but one card places "
                                 f"every leaf whole; pass None or a mesh")
            return x.to(dev) if isinstance(x, torch.Tensor) else x
        return _walk(tree, spec_tree, put_one)

    def put(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        spec = () if spec is None else getattr(spec, "spec", spec)
        return rules.place(x, rules.NamedSharding(mesh, tuple(spec)))
    return _walk(tree, spec_tree, put)


def heal_crawler(state, cfg, dead_shards: Sequence[int], n_shards: int):
    """Rebalance the dead shards' domains onto the survivors, balanced by
    frontier depth, and migrate their rows. Returns the new state. Under
    a crawl group every rank plans from the gathered row depths, so every
    rank gets the same map, and the rows cross ranks."""
    from repro_torch.dist import CrawlGroup
    depth = CrawlGroup.current().gather(state.f_valid.sum(dim=1))
    loads = depth.cpu().numpy().astype(np.float64)
    per = cfg.n_slots // n_shards
    shard_loads = loads.reshape(n_shards, per).sum(axis=1)
    # each domain's weight in the same unit (frontier depth), at least 1:
    # an empty orphan still takes a slot, so empty placements spread
    domain_loads = np.maximum(
        loads[state.slot_of_domain.cpu().numpy()], 1.0)
    dm = CR.domain_map(state)
    dm = dm._replace(shard_alive=torch.ones_like(dm.shard_alive))
    new_dm = PT.rebalance(dm, list(dead_shards), loads=shard_loads,
                          domain_loads=domain_loads)
    return CR.apply_rebalance(state, cfg, new_dm)


def revive(state, shard_ids: Sequence[int]):
    """Bring shards back (a straggler recovered, a replacement joined)."""
    alive = state.shard_alive.clone()
    for s in shard_ids:
        alive[s] = True
    return state._replace(shard_alive=alive)
