"""Phase I — the partitioned Global URL Frontier, the domain <-> slot maps,
and the PARTITIONING-POLICY REGISTRY the crawl stages resolve through.
Counterpart of ``repro/core/partitioner.py``.

Ported here: ``DomainMap``, ``identity_map``, ``shard_of_slot``,
``seed_frontier`` and the three policies (webparf, url_hash, random). The
C4 heal machinery (``rebalance``, ``migrate_rows``, ``move_domain``) is the
next slice of the port.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import frontier as F
from repro_torch.core import ranker
from repro_torch.core import webgraph as W
from repro_torch.core.dedup import exact_dedup


class DomainMap(NamedTuple):
    slot_of_domain: torch.Tensor    # (n_domains,) int32
    domain_of_slot: torch.Tensor    # (n_slots,) int32 (-1 = empty slot)
    shard_alive: torch.Tensor       # (n_shards,) bool


def identity_map(cfg: CrawlConfig, n_shards: int, device) -> DomainMap:
    """Shard s hosts domains [s*d, (s+1)*d) in its first d slots; the rest
    of its slots are spare."""
    n, ns = cfg.n_domains, cfg.n_slots
    per_dom, per_slot = n // n_shards, ns // n_shards
    dom = np.arange(n)
    slot = (dom // per_dom) * per_slot + dom % per_dom
    domain_of_slot = np.full(ns, -1, np.int32)
    domain_of_slot[slot] = dom
    return DomainMap(
        slot_of_domain=torch.tensor(slot, dtype=torch.int32, device=device),
        domain_of_slot=torch.tensor(domain_of_slot, device=device),
        shard_alive=torch.ones((n_shards,), dtype=torch.bool, device=device))


def shard_of_slot(slot: torch.Tensor, n_slots: int,
                  n_shards: int) -> torch.Tensor:
    return torch.div(slot, n_slots // n_shards, rounding_mode="floor")


def seed_frontier(cfg: CrawlConfig, n_shards: int, device) -> F.Frontier:
    """Gather hub seeds per domain and build the initial prioritized queues
    at each domain's slot."""
    dm = identity_map(cfg, n_shards, device)
    f = F.init_frontier(cfg.n_slots, cfg.frontier_capacity, device)
    seeds = W.hub_seeds(cfg, device)                      # (n_domains, N)
    seed_mask = exact_dedup(seeds, torch.ones(seeds.shape, dtype=torch.bool,
                                              device=device))
    slots = dm.slot_of_domain.to(torch.int64)
    by_slot = torch.zeros((cfg.n_slots, seeds.shape[1]), dtype=torch.int64,
                          device=device)
    by_slot[slots] = seeds
    mask = torch.zeros((cfg.n_slots, seeds.shape[1]), dtype=torch.bool,
                       device=device)
    mask[slots] = seed_mask
    scores = ranker.score_urls(by_slot, cfg)
    return F.insert(f, by_slot, scores, mask,
                    n_buckets=cfg.n_priority_buckets)


# ---------------------------------------------------------------------------
# partitioning-policy registry
# ---------------------------------------------------------------------------

class PartitionPolicy(NamedTuple):
    """The three per-step decisions a partitioning scheme owns.

      canonicalize     — fold URL aliases before dispatch (C2)?
      split_ownership  — (cfg, state, true_dom, sel) -> (own, foreign).
      route            — (cfg, state, n_shards, urls, pred_dom, step) ->
                         destination shard of each staged URL.
      local_row        — (cfg, state, shard, r_slots, urls, pred_dom) ->
                         (row, ok): local row of each received URL, and
                         whether this shard owns it.
    """
    name: str
    canonicalize: bool
    split_ownership: Callable
    route: Callable
    local_row: Callable


_POLICIES: Dict[str, PartitionPolicy] = {}


def register_policy(policy: PartitionPolicy) -> PartitionPolicy:
    """Register a policy under ``policy.name`` (error on conflicting re-use)."""
    if policy.name in _POLICIES and _POLICIES[policy.name] is not policy:
        raise ValueError(f"partitioning policy {policy.name!r} registered twice")
    _POLICIES[policy.name] = policy
    return policy


def policies() -> Tuple[str, ...]:
    return tuple(sorted(_POLICIES))


def get_policy(name: str) -> PartitionPolicy:
    """Resolve a ``cfg.partitioning`` string to its registered policy."""
    if name not in _POLICIES:
        raise KeyError(f"unknown partitioning policy {name!r}; "
                       f"registered: {policies()}")
    return _POLICIES[name]


def _slot_of(cfg, state, pred_dom):
    idx = torch.clamp(pred_dom, 0, cfg.n_domains - 1).to(torch.int64)
    return state.slot_of_domain.to(torch.int64)[idx]


def _webparf_split(cfg, state, true_dom, sel):
    own = (true_dom == state.slot_domain[:, None]) & sel
    return own, sel & ~own


def _webparf_route(cfg, state, n_shards, urls, pred_dom, step):
    return shard_of_slot(_slot_of(cfg, state, pred_dom), cfg.n_slots,
                         n_shards)


def _webparf_row(cfg, state, shard, r_slots, urls, pred_dom):
    row = _slot_of(cfg, state, pred_dom) - shard * r_slots
    ok = (row >= 0) & (row < r_slots)
    return torch.clamp(row, 0, r_slots - 1), ok


def _all_own(cfg, state, true_dom, sel):
    return sel, torch.zeros_like(sel)


def _hash_route(cfg, state, n_shards, urls, pred_dom, step):
    return W.hash2(urls, 61) % n_shards


def _random_route(cfg, state, n_shards, urls, pred_dom, step):
    # unstable destination: re-keyed every dispatch round (uint32 step + 62)
    return W.hash2(urls, (step.to(torch.int64) + 62) & W.M32) % n_shards


def _hash_row(cfg, state, shard, r_slots, urls, pred_dom):
    row = W.hash2(urls, 63) % r_slots
    return row, torch.ones(urls.shape, dtype=torch.bool, device=urls.device)


WEBPARF = register_policy(PartitionPolicy(
    "webparf", True, _webparf_split, _webparf_route, _webparf_row))
URL_HASH = register_policy(PartitionPolicy(
    "url_hash", False, _all_own, _hash_route, _hash_row))
RANDOM = register_policy(PartitionPolicy(
    "random", False, _all_own, _random_route, _hash_row))
