"""Coordination-mode registry. Counterpart of
``repro/coordination/registry.py``.

``CrawlConfig.coordination`` names what a crawl process does with the URLs
it discovers at dispatch time. The port has the paper's default,
``exchange`` (ship every staged URL to its predicted owner). ``firewall``,
``crossover`` and ``batched`` are a later slice of the port and raise.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

NOT_PORTED = ("firewall", "crossover", "batched")


class DispatchPlan(NamedTuple):
    """One dispatch round's fate for every item of the candidate pool;
    ``ship``, ``keep`` and ``defer`` are disjoint."""
    ship: torch.Tensor      # (N,) bool — transmit through the exchange
    keep: torch.Tensor      # (N,) bool — process locally
    defer: torch.Tensor     # (N,) bool — park for a later dispatch
    drop: torch.Tensor      # (N,) bool — discard now (refunded + counted)
    foreign: torch.Tensor   # (N,) bool — kept items this shard does not own


class CoordinationPolicy(NamedTuple):
    """One coordination mode. The flags decide what the dispatch stage
    runs; ``plan`` is (ctx, state, shard, u, src, val, dest, staged, valid)
    -> DispatchPlan, for every shard's staged items at once: the item
    tensors are (n_shards, S) and ``shard`` is each item's sending shard,
    (n_shards, 1), so that a mode can test ``dest != shard``."""
    name: str
    communicates: bool
    uses_outbox: bool
    keeps_foreign: bool
    plan: Callable


_POLICIES: Dict[str, CoordinationPolicy] = {}


def register_coordination(policy: CoordinationPolicy) -> CoordinationPolicy:
    """Register under ``policy.name`` (error on conflicting re-use)."""
    if policy.name in _POLICIES and _POLICIES[policy.name] is not policy:
        raise ValueError(
            f"coordination policy {policy.name!r} registered twice")
    _POLICIES[policy.name] = policy
    return policy


def coordinations() -> Tuple[str, ...]:
    import repro_torch.coordination.policies  # noqa: F401  (registers)
    return tuple(sorted(_POLICIES))


def get_coordination(name: str) -> CoordinationPolicy:
    """Resolve a ``cfg.coordination`` string to its registered policy."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"coordination {name!r} is not ported yet (ROADMAP Queue 1: "
            f"coordination/policies.py firewall, crossover, batched)")
    import repro_torch.coordination.policies  # noqa: F401  (registers)
    if name not in _POLICIES:
        raise KeyError(f"unknown coordination policy {name!r}; "
                       f"registered: {coordinations()}")
    return _POLICIES[name]
