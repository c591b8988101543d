"""The configurations of the PyTorch port.

Copies of ``repro.configs.base``'s ``ShapeSpec``, ``LM_SHAPES``,
``GNN_SHAPES``, ``RECSYS_SHAPES``, ``CRAWL_SHAPES``, ``MoEConfig``,
``LMConfig``, ``GNNConfig``, ``RecSysConfig`` and ``CrawlConfig`` (field
names, defaults and shape dims are held equal by
tests/test_torch_boundary.py): the port keeps its own copies so it imports
nothing of the JAX package. Every family is ported: the crawl, the LMs
(dense and MoE), the GAT and the four RecSys models.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    """One (arch x shape) cell; ``kind`` names the step it drives (lm:
    "train", "prefill", "decode"; gnn: "full_graph", "minibatch",
    "batched_graphs"; recsys: "train", "serve", "retrieval")."""
    name: str
    kind: str
    dims: Dict[str, int] = field(default_factory=dict)

    def __getitem__(self, k: str) -> int:
        return self.dims[k]

    def get(self, k: str, default: int = 0) -> int:
        return self.dims.get(k, default)


LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
)

GNN_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("full_graph_sm", "full_graph",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    ShapeSpec("minibatch_lg", "minibatch",
              dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                   fanout0=15, fanout1=10, d_feat=602, n_classes=41)),
    ShapeSpec("ogb_products", "full_graph",
              dict(n_nodes=2449029, n_edges=61859140, d_feat=100, n_classes=47)),
    ShapeSpec("molecule", "batched_graphs",
              dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, n_classes=2)),
)

RECSYS_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_batch", "train", dict(batch=65536)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    ShapeSpec("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)),
)

CRAWL_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("crawl_step", "crawl", dict()),
)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int               # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # always-on shared experts (DeepSeekMoE)
    dense_residual: bool = False # parallel dense MLP branch (Arctic)
    d_ff_dense: int = 0          # width of dense residual / first-k-dense MLP
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    router_jitter: float = 0.0


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    family: str = "lm"
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0       # first k layers use the dense MLP even in MoE models
    dtype: str = "bfloat16"
    remat: bool = True           # activation checkpointing per layer (train)
    scan_layers: bool = True     # the port holds its layers in a ModuleList

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding + per-layer), analytic."""
        d, h = self.d_model, self.head_dim
        attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * h
        dense_mlp = 3 * d * self.d_ff
        per_layer = []
        for i in range(self.n_layers):
            mlp = dense_mlp
            if self.moe is not None and i >= self.first_k_dense:
                m = self.moe
                mlp = (m.n_experts + m.n_shared) * 3 * d * m.d_ff_expert + d * m.n_experts
                if m.dense_residual:
                    mlp += 3 * d * (m.d_ff_dense or self.d_ff)
            per_layer.append(attn + mlp + 2 * d)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return embed + sum(per_layer) + d

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts count)."""
        if self.moe is None:
            return self.n_params
        d = self.d_model
        m = self.moe
        full_moe = (m.n_experts + m.n_shared) * 3 * d * m.d_ff_expert
        act_moe = (m.top_k + m.n_shared) * 3 * d * m.d_ff_expert
        n_moe_layers = self.n_layers - self.first_k_dense
        return self.n_params - n_moe_layers * (full_moe - act_moe)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    n_heads: int
    aggregator: str = "attn"     # GAT edge-softmax attention
    family: str = "gnn"
    attn_dropout: float = 0.6    # not applied, as in the reference
    negative_slope: float = 0.2
    dtype: str = "float32"


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RecSysConfig:
    name: str
    kind: str                    # "bert4rec" | "dien" | "wide_deep" | "dcn_v2"
    embed_dim: int
    family: str = "recsys"
    # sequential models
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    gru_dim: int = 0
    # tabular models
    n_dense: int = 0
    n_sparse: int = 0
    n_cross_layers: int = 0
    mlp_dims: Tuple[int, ...] = ()
    # embedding tables: (table_name -> n_rows); the lookup is the hot path
    tables: Dict[str, int] = field(default_factory=dict)
    # multi-hot fields use an embedding bag; bag size per field
    multi_hot: Dict[str, int] = field(default_factory=dict)
    dtype: str = "float32"
    interaction: str = ""

    @property
    def total_rows(self) -> int:
        return sum(self.tables.values())


# ---------------------------------------------------------------------------
# WebParF (the paper's own system) config
# ---------------------------------------------------------------------------


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
    ordering: str = "backlink"        # "fifo" | "backlink" | "learned" |
                                      # "opic" | "opic_url", all ported
    coordination: str = "exchange"    # "exchange" | "firewall" |
                                      # "crossover" | "batched"
    comm_quota: int = -1              # "batched": URLs shipped per shard
                                      # per dispatch (< 0: no bound)
    slot_factor: int = 2              # frontier rows per domain
    kernel_impl: str = "auto"         # the port dispatches by device: a CUDA
                                      # tensor runs the hand-written kernel, a
                                      # CPU tensor its plain version; only
                                      # "auto" is accepted
    telemetry: bool = False           # the load ledger and spans (obs/)
    rebalance: str = "hot_domain"     # rebalance policy (rebalance/)
    rebalance_threshold: float = 0.0  # > 0: load-driven rebalance (needs
                                      # telemetry)
    rebalance_window: int = 2
    rebalance_max_domains: int = 4
    fused_dispatch: bool = True       # acts only for url-lane orderings

    @property
    def n_slots(self) -> int:
        return self.n_domains * self.slot_factor


ArchConfig = Union[LMConfig, GNNConfig, RecSysConfig, CrawlConfig]


def scaled(cfg, **overrides):
    """Return a copy of a frozen config with fields replaced."""
    return dataclasses.replace(cfg, **overrides)
