"""The crawl configuration of the PyTorch port.

A copy of ``repro.configs.base.CrawlConfig`` (field names and defaults are
held equal by tests/test_torch_boundary.py): the port keeps its own copy so it
imports nothing of the JAX package. Only the crawl family is ported; the
LM/GNN/RecSys config classes stay with the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class CrawlConfig:
    """WebParF crawl-simulation configuration (the paper's system)."""
    name: str = "webparf"
    family: str = "crawl"
    n_domains: int = 256              # topical domains (Phase I partitions)
    frontier_capacity: int = 4096     # per-domain priority-queue capacity
    fetch_batch: int = 64             # URLs fetched per shard per step
    outlinks_per_page: int = 16       # parser yield per page
    n_priority_buckets: int = 8       # prioritized-queue levels (Fig. 5)
    bloom_bits_log2: int = 24         # byte-per-bit Bloom row: 2^24 entries
    bloom_hashes: int = 4
    dispatch_interval: int = 4        # steps between batched URL exchanges (C5)
    dispatch_capacity: int = 2048     # max URLs exchanged per shard per dispatch
    topical_locality: float = 0.8     # P(outlink stays in-domain)
    link_pop_bias: float = 0.0        # P(an outlink's local target is
                                      # tournament-picked by popularity)
    alias_fraction: float = 0.05      # URLs that alias another page's content (C2)
    url_space_log2: int = 30          # 2^30 synthetic URL ids
    seed_urls_per_domain: int = 32    # Phase I hub seeds per domain pool
    zipf_a: float = 1.1               # domain-size skew
    partitioning: str = "webparf"     # "webparf" | "url_hash" | "random"
    ordering: str = "backlink"        # "fifo" | "backlink" | "learned" here;
                                      # "opic" | "opic_url" are not ported yet
    coordination: str = "exchange"    # only "exchange" is ported
    comm_quota: int = -1              # "batched" only (not ported)
    slot_factor: int = 2              # frontier rows per domain
    kernel_impl: str = "auto"         # the port dispatches by device: a CUDA
                                      # tensor runs the hand-written kernel, a
                                      # CPU tensor its plain version; only
                                      # "auto" is accepted
    telemetry: bool = False           # not ported
    rebalance: str = "hot_domain"     # not ported
    rebalance_threshold: float = 0.0  # > 0 is not ported
    rebalance_window: int = 2
    rebalance_max_domains: int = 4
    fused_dispatch: bool = True       # acts only for url-lane orderings

    @property
    def n_slots(self) -> int:
        return self.n_domains * self.slot_factor


def scaled(cfg, **overrides):
    """Return a copy of a frozen config with fields replaced."""
    return dataclasses.replace(cfg, **overrides)
