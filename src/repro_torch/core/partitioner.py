"""Phase I — the partitioned Global URL Frontier, the domain <-> slot maps,
and the PARTITIONING-POLICY REGISTRY the crawl stages resolve through.
Counterpart of ``repro/core/partitioner.py``.

Frontier and Bloom rows are indexed by SLOT, and ``slot_of_domain`` says
where each domain lives; shard s owns slots [s * r, (s + 1) * r). The
policies' decisions take the shard of each row or item as a tensor that
broadcasts against the items, so one call serves every shard of the
batched step. The C3/C4 control plane (``rebalance``, ``move_domain``,
``migrate_domains``, ``split_domains``) is host-side numpy; the row
migration (``migrate_rows``) is a torch gather on the state's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

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
    # from the numpy arrays, not through a torch copy on the host: on meta
    # (the dry run) no storage is made
    return DomainMap(
        slot_of_domain=torch.from_numpy(slot.astype(np.int32)).to(device),
        domain_of_slot=torch.from_numpy(domain_of_slot).to(device),
        shard_alive=torch.ones((n_shards,), dtype=torch.bool, device=device))


def shard_of_slot(slot: torch.Tensor, n_slots: int,
                  n_shards: int) -> torch.Tensor:
    return torch.div(slot, n_slots // n_shards, rounding_mode="floor")


def seed_frontier(cfg: CrawlConfig, n_shards: int, device) -> F.Frontier:
    """Gather hub seeds per domain and build the initial prioritized queues
    at each domain's slot: under a crawl group, the rank's own rows only,
    each equal to the one-process row. On ``meta`` (the dry run) the
    queues keep their empty shapes: the insert reads the host, and fills
    no new storage."""
    from repro_torch.dist import CrawlGroup
    group = CrawlGroup.current()
    n_rows = group.split(n_shards)[0] * (cfg.n_slots // n_shards)
    f = F.init_frontier(n_rows, cfg.frontier_capacity, device)
    if torch.device(device).type == "meta":
        return f
    dm = identity_map(cfg, n_shards, device)
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
    # every row is seeded on its own: the rank's rows are a slice
    by_slot = group.local(by_slot, n_shards)
    mask = group.local(mask, n_shards)
    scores = ranker.score_urls(by_slot, cfg)
    return F.insert(f, by_slot, scores, mask,
                    n_buckets=cfg.n_priority_buckets)


def _free_slot(domain_of_slot: np.ndarray, shard: int, per: int) -> int:
    """First free slot on ``shard``; -1 if the shard is full."""
    for tslot in range(shard * per, (shard + 1) * per):
        if domain_of_slot[tslot] < 0:
            return tslot
    return -1


def _host_maps(dm: DomainMap):
    return (dm.slot_of_domain.cpu().numpy().copy(),
            dm.domain_of_slot.cpu().numpy().copy(),
            dm.shard_alive.cpu().numpy().copy())


def _device_map(slot_of_domain, domain_of_slot, alive, device) -> DomainMap:
    return DomainMap(
        torch.tensor(slot_of_domain, dtype=torch.int32, device=device),
        torch.tensor(domain_of_slot, dtype=torch.int32, device=device),
        torch.tensor(alive, dtype=torch.bool, device=device))


def rebalance(dm: DomainMap, dead_shards: Sequence[int], *,
              loads: Optional[np.ndarray] = None,
              domain_loads: Optional[np.ndarray] = None) -> DomainMap:
    """C4: move each dead shard's domains to the least-loaded live shard
    with a free slot (host-side control plane). ``loads`` is the per-shard
    load, ``domain_loads`` each domain's weight in the same unit (each
    placement credits it to its target; +1 without it). With no free slot
    anywhere a domain merges into the least-loaded shard's slot
    ``d % per``."""
    slot_of_domain, domain_of_slot, alive = _host_maps(dm)
    n_slots, n_shards = len(domain_of_slot), len(alive)
    per = n_slots // n_shards
    alive[list(dead_shards)] = False
    live = np.where(alive)[0]
    if len(live) == 0:
        raise ValueError("rebalance: no live shards remain")
    loads = (np.zeros(n_shards) if loads is None
             else np.asarray(loads, np.float64).copy())

    def credit(d):
        return 1.0 if domain_loads is None else float(domain_loads[d])

    for s in dead_shards:
        for slot in range(s * per, (s + 1) * per):
            d = domain_of_slot[slot]
            if d < 0:
                continue
            order = live[np.argsort(loads[live], kind="stable")]
            for tgt_shard in order:
                tslot = _free_slot(domain_of_slot, tgt_shard, per)
                if tslot >= 0:
                    domain_of_slot[tslot] = d
                    break
            else:
                # no free slot: the domain shares a row (merge)
                tgt_shard = order[0]
                tslot = tgt_shard * per + (d % per)
            domain_of_slot[slot] = -1
            slot_of_domain[d] = tslot
            loads[tgt_shard] += credit(d)
    return _device_map(slot_of_domain, domain_of_slot, alive,
                       dm.slot_of_domain.device)


def move_domain(dm: DomainMap, domain: int, target_slot: int) -> DomainMap:
    """Elementary live->live move of one domain into a FREE slot (same
    shard allowed). Only the maps change; ``crawler.apply_rebalance``
    migrates the rows."""
    slot_of_domain, domain_of_slot, alive = _host_maps(dm)
    slot = int(slot_of_domain[domain])
    if domain_of_slot[slot] != domain:
        raise ValueError(f"move_domain: domain {domain} shares slot {slot} "
                         f"(merged) — cannot move it independently")
    if domain_of_slot[target_slot] >= 0:
        raise ValueError(f"move_domain: target slot {target_slot} is "
                         f"occupied by domain {int(domain_of_slot[target_slot])}")
    domain_of_slot[target_slot] = domain
    domain_of_slot[slot] = -1
    slot_of_domain[domain] = target_slot
    return _device_map(slot_of_domain, domain_of_slot, alive,
                       dm.slot_of_domain.device)


def migrate_domains(dm: DomainMap, domains: Sequence[int], *,
                    loads: np.ndarray,
                    domain_loads: Optional[np.ndarray] = None,
                    limit: Optional[int] = None,
                    improve_only: bool = False
                    ) -> Tuple[DomainMap, List[Tuple[int, int, int]]]:
    """Live->live migration: each candidate domain, in order, moves to the
    least-loaded OTHER live shard with a free slot (never a merge; a domain
    that finds none is skipped). Each move debits ``domain_loads[d]`` (+1
    without it) from the source and credits the target; ``improve_only``
    skips moves that would not lower the pair's peak. Returns ``(new_map,
    [(domain, src_shard, dst_shard), ...])``; liveness is unchanged."""
    slot_of_domain, domain_of_slot, alive = _host_maps(dm)
    per = len(domain_of_slot) // len(alive)
    live = np.where(alive)[0]
    loads = np.asarray(loads, np.float64).copy()
    moves: List[Tuple[int, int, int]] = []
    if len(live) < 2:
        return dm, moves
    for d in domains:
        if limit is not None and len(moves) >= limit:
            break
        d = int(d)
        slot = int(slot_of_domain[d])
        if domain_of_slot[slot] != d:
            continue                   # merged domain shares a row: skip
        src_shard = slot // per
        w = 1.0 if domain_loads is None else float(domain_loads[d])
        placed = None
        for tgt_shard in live[np.argsort(loads[live], kind="stable")]:
            if tgt_shard == src_shard:
                continue
            tslot = _free_slot(domain_of_slot, tgt_shard, per)
            if tslot >= 0:
                placed = (int(tgt_shard), tslot)
                break
        if placed is None:
            continue
        tgt_shard, tslot = placed
        if improve_only and loads[tgt_shard] + w >= loads[src_shard]:
            continue
        domain_of_slot[tslot] = d
        domain_of_slot[slot] = -1
        slot_of_domain[d] = tslot
        loads[tgt_shard] += w
        loads[src_shard] -= w
        moves.append((d, src_shard, tgt_shard))
    if not moves:
        return dm, moves
    return _device_map(slot_of_domain, domain_of_slot, alive,
                       dm.slot_of_domain.device), moves


def source_slots(old_map: DomainMap, new_map: DomainMap) -> torch.Tensor:
    """For every slot of the new map, the slot its domain occupied in the
    old one (its own index where it holds no domain)."""
    dom = new_map.domain_of_slot.to(torch.int64)
    own = torch.arange(dom.shape[0], device=dom.device)
    return torch.where(
        dom >= 0,
        old_map.slot_of_domain.to(torch.int64)[torch.clamp(dom, min=0)], own)


def migrate_rows(arrs: Dict[str, torch.Tensor], old_map: DomainMap,
                 new_map: DomainMap, *, rows: Sequence[str]
                 ) -> Dict[str, torch.Tensor]:
    """Permute the named row-indexed leaves (leading axis = n_slots) after
    a remap: every new slot pulls the row of the slot its domain used to
    occupy. A gather, so a moved row's old slot keeps a stale copy. Other
    entries pass through; a named leaf that is not row-indexed raises."""
    n_slots = old_map.domain_of_slot.shape[0]
    src = source_slots(old_map, new_map)
    out = dict(arrs)
    for k in rows:
        a = out[k]
        if a.dim() < 1 or a.shape[0] != n_slots:
            raise ValueError(f"migrate_rows: leaf {k!r} has shape "
                             f"{tuple(a.shape)}, not row-indexed by "
                             f"n_slots={n_slots}")
        out[k] = a[src]
    return out


def split_domains(cfg: CrawlConfig) -> CrawlConfig:
    """C3 elasticity: split every domain into two (the partition count
    doubles). URL ids are stable: one more bit of the local space becomes
    part of the domain id."""
    if cfg.url_space_log2 <= int(np.log2(cfg.n_domains)) + 1:
        raise ValueError(f"split_domains: url_space_log2="
                         f"{cfg.url_space_log2} leaves no local bit to "
                         f"split {cfg.n_domains} domains")
    return dataclasses.replace(cfg, n_domains=cfg.n_domains * 2)


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
                         whether its receiving shard owns it.

    ``state`` is the whole batched state (every row, the replicated maps);
    ``shard`` is each item's shard (a tensor broadcasting against
    ``urls``), ``r_slots`` the rows a shard owns.
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
