"""Coordination-mode registry. Counterpart of
``repro/coordination/registry.py``.

``CrawlConfig.coordination`` names what a crawl process does with the URLs
it discovers at dispatch time: ``exchange`` ships every staged URL to its
predicted owner (the paper's default), ``firewall`` keeps its own and drops
foreign ones, ``crossover`` keeps both without communicating, and
``batched`` ships a bounded top-k a dispatch and parks the rest in the
outbox (``coordination/outbox.py``). A third-party mode registers with
``register_coordination`` and is selected by name like the built-ins.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch


class DispatchPlan(NamedTuple):
    """One dispatch round's fate for every item of the candidate pool (the
    staging batch, after the parked outbox for ``uses_outbox`` modes);
    ``ship``, ``keep`` and ``defer`` are disjoint. ``ship``/``keep`` pick
    from the valid (staged and alive) items, ``defer`` from the staged
    ones. A staged item in none of them, or dropped by the exchange's
    bucket overflow, refunds its value to its source page's row."""
    ship: torch.Tensor      # (N,) bool — transmit through the exchange
    keep: torch.Tensor      # (N,) bool — process locally
    defer: torch.Tensor     # (N,) bool — park for a later dispatch
    drop: torch.Tensor      # (N,) bool — discard now (refunded + counted)
    foreign: torch.Tensor   # (N,) bool — kept items this shard does not own


class CoordinationPolicy(NamedTuple):
    """One coordination mode. The flags decide what the dispatch stage
    runs; ``plan`` is (ctx, state, shard, u, src, val, dest, staged, valid)
    -> DispatchPlan, for the staged items of every shard the process
    holds at once: the item tensors are (n_local, S) and ``shard`` is each
    item's sending shard as a global id, (n_local, 1), so that a mode can
    test ``dest != shard``."""
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
    import repro_torch.coordination.policies  # noqa: F401  (registers)
    if name not in _POLICIES:
        raise KeyError(f"unknown coordination policy {name!r}; "
                       f"registered: {coordinations()}")
    return _POLICIES[name]
