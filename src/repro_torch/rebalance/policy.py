"""Load-driven elastic repartitioning: the rebalance-policy registry. A
port copy of ``repro/rebalance/policy.py`` (a numpy plan on the host).

The C4 heal reacts to a shard's death; a crawl skews long before that, and
the telemetry ledger's load-imbalance factor shows it. A
:class:`RebalancePolicy` turns that signal into a migration plan (a new
:class:`~repro_torch.core.partitioner.DomainMap` and the moves taken), or
``None`` when no move pays. ``CrawlSession.maybe_rebalance`` applies the
plan through ``crawler.apply_rebalance``, the cash-conserving row
migration the heal uses, here live -> live.

The built-in ``hot_domain`` policy ranks the peak shard's domains by heat
(frontier depth + ordering cash) and hands the hottest to
``partitioner.migrate_domains``: least-loaded placement, load credits, and
``improve_only`` so that a move that merely relocates the peak is skipped.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import partitioner as PT


@dataclasses.dataclass(frozen=True)
class RebalanceDecision:
    """One migration plan: the remapped domain layout plus its bookkeeping.
    ``moves`` are ``(domain, src_shard, dst_shard)``; the imbalance numbers
    are the policy's own max/mean-over-live-shards estimate before and
    after applying the plan (same metric as the trigger)."""
    new_map: PT.DomainMap
    moves: Tuple[Tuple[int, int, int], ...]
    imbalance_before: float
    imbalance_after: float

    @property
    def domains(self) -> Tuple[int, ...]:
        return tuple(m[0] for m in self.moves)

    @property
    def dst_shards(self) -> Tuple[int, ...]:
        return tuple(m[2] for m in self.moves)


@dataclasses.dataclass(frozen=True)
class RebalanceEvent:
    """What ``CrawlSession.maybe_rebalance`` records per applied decision —
    surfaced on ``CrawlReport.rebalances`` and as a trace instant."""
    step: int                      # session step the decision fired at
    trigger: float                 # windowed imbalance that crossed the gate
    moves: Tuple[Tuple[int, int, int], ...]
    imbalance_before: float
    imbalance_after: float

    @property
    def domains(self) -> Tuple[int, ...]:
        return tuple(m[0] for m in self.moves)

    def asdict(self) -> Dict:
        return dict(step=self.step, trigger=round(self.trigger, 4),
                    moves=[list(m) for m in self.moves],
                    imbalance_before=round(self.imbalance_before, 4),
                    imbalance_after=round(self.imbalance_after, 4))


class RebalancePolicy(NamedTuple):
    """``plan(cfg, dm, row_depth, row_cash) -> Optional[RebalanceDecision]``

    ``row_depth`` / ``row_cash`` are host-side ``(n_slots,)`` f64 views of
    per-row frontier depth and ordering cash (slot pool + URL lane) — the
    load signals. The policy must not mutate them."""
    name: str
    plan: Callable


_POLICIES: Dict[str, RebalancePolicy] = {}


def register_rebalance(policy: RebalancePolicy) -> RebalancePolicy:
    """Register a policy under ``policy.name`` (error on conflicting re-use)."""
    if policy.name in _POLICIES and _POLICIES[policy.name] is not policy:
        raise ValueError(f"rebalance policy {policy.name!r} registered twice")
    _POLICIES[policy.name] = policy
    return policy


def rebalances() -> Tuple[str, ...]:
    return tuple(sorted(_POLICIES))


def get_rebalance(name: str) -> RebalancePolicy:
    """Resolve a ``cfg.rebalance`` string to its registered policy."""
    if name not in _POLICIES:
        raise KeyError(f"unknown rebalance policy {name!r}; "
                       f"registered: {rebalances()}")
    return _POLICIES[name]


def _imbalance(loads: np.ndarray, live: np.ndarray) -> float:
    mean = loads[live].mean()
    if mean <= 0:
        return 1.0
    return float(loads[live].max() / mean)


def _hot_domain_plan(cfg: CrawlConfig, dm: PT.DomainMap,
                     row_depth: np.ndarray, row_cash: np.ndarray
                     ) -> Optional[RebalanceDecision]:
    alive = dm.shard_alive.cpu().numpy()
    domain_of_slot = dm.domain_of_slot.cpu().numpy()
    n_slots = len(domain_of_slot)
    n_shards = len(alive)
    per = n_slots // n_shards
    live = np.flatnonzero(alive)
    if len(live) < 2:
        return None                    # nowhere to move load to
    loads = row_depth.reshape(n_shards, per).sum(axis=1)
    loads = np.where(alive, loads, 0.0)
    if loads[live].sum() <= 0:
        return None
    src = int(live[np.argmax(loads[live])])

    # the peak shard's domains, hottest first: depth is the load that moves,
    # cash breaks ties toward queues the ordering is about to grow
    slots = np.arange(src * per, (src + 1) * per)
    heat = row_depth[slots] + row_cash[slots]
    order = slots[np.argsort(-heat, kind="stable")]
    candidates = [int(domain_of_slot[s]) for s in order
                  if domain_of_slot[s] >= 0 and heat[s - src * per] > 0]
    if not candidates:
        return None

    domain_loads = np.zeros(cfg.n_domains)
    mapped = domain_of_slot >= 0
    domain_loads[domain_of_slot[mapped]] = row_depth[mapped]
    new_dm, moves = PT.migrate_domains(
        dm, candidates, loads=loads, domain_loads=domain_loads,
        limit=max(cfg.rebalance_max_domains, 1), improve_only=True)
    if not moves:
        return None
    loads_after = loads.copy()
    for d, s, t in moves:
        loads_after[s] -= domain_loads[d]
        loads_after[t] += domain_loads[d]
    return RebalanceDecision(
        new_map=new_dm, moves=tuple(moves),
        imbalance_before=_imbalance(loads, live),
        imbalance_after=_imbalance(loads_after, live))


HOT_DOMAIN = register_rebalance(RebalancePolicy("hot_domain",
                                                _hot_domain_plan))
