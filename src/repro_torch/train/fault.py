"""Fault tolerance. Counterpart of ``repro/train/fault.py``:

1. **Checkpoint/restart**: ``run_with_failures`` drives a step function
   with injected failures; on a failure it restores the last checkpoint
   and replays. With deterministic steps the result equals a run without
   failures bit for bit.
2. **Crawler domain rebalance (C4)**: ``heal_crawler`` moves a dead
   shard's domains to the survivors and migrates their rows; ``revive``
   brings shards back.

The reference's third mechanism, ``reshard`` (placing a restored state on
a mesh of another shape), comes with the sharding decisions of ROADMAP
Queue 1, item 18d.
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


def heal_crawler(state, cfg, dead_shards: Sequence[int], n_shards: int):
    """Rebalance the dead shards' domains onto the survivors, balanced by
    frontier depth, and migrate their rows. Returns the new state."""
    loads = state.f_valid.sum(dim=1).cpu().numpy().astype(np.float64)
    per = cfg.n_slots // n_shards
    shard_loads = loads.reshape(n_shards, per).sum(axis=1)
    # each domain's weight in the same unit (frontier depth), at least 1:
    # an empty orphan still takes a slot, so empty placements spread
    domain_loads = np.maximum(
        loads[state.slot_of_domain.cpu().numpy()], 1.0)
    dm = PT.DomainMap(state.slot_of_domain, state.slot_domain,
                      torch.ones_like(state.shard_alive))
    new_dm = PT.rebalance(dm, list(dead_shards), loads=shard_loads,
                          domain_loads=domain_loads)
    return CR.apply_rebalance(state, cfg, new_dm)


def revive(state, shard_ids: Sequence[int]):
    """Bring shards back (a straggler recovered, a replacement joined)."""
    alive = state.shard_alive.clone()
    for s in shard_ids:
        alive[s] = True
    return state._replace(shard_alive=alive)
