"""Crawler fault controls (C4). Counterpart of the crawler half of
``repro/train/fault.py``: ``heal_crawler`` moves a dead shard's domains to
the survivors and migrates their rows, ``revive`` brings shards back.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import crawler as CR
from repro_torch.core import partitioner as PT


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
