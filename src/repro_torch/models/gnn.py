"""GAT [arXiv:1710.10903] via edge-index message passing. Counterpart of
``repro/models/gnn.py``.

Message passing is built from first principles, as in the reference:
gather src/dst features along an edge list, segment-softmax the edge
scores per destination (a segment max for stability, a segment sum to
normalise), and scatter-add the messages. The segment sums and the
gathers' gradients are ``models/segment.py``'s: each edge index is sorted
once a forward (stably, so a node's edges keep their order) and every sum
over a node's edges runs in that order, so two runs on the card give the
same bits (``index_add_`` would add in the atomics' order).

Three shape regimes:
  full_graph      — one (N, E) graph, semi-supervised node classification
  minibatch       — fanout-sampled blocks from data/sampler.py (padded)
  batched_graphs  — (batch, n, e) small molecule graphs, flattened into one
                    graph of disjoint parts (the reference vmaps)

Parameters are a flat dict keyed by the reference's checkpoint paths
(``layers/<i>/w``, ``layers/<i>/a_src``, ``layers/<i>/a_dst``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.device import Device, resolve_device
from repro_torch.models.segment import (Segments, gather, segment_max,
                                        segment_sum)
from repro_torch.optim import common
from repro_torch.sharding.rules import constrain

Params = Dict[str, torch.Tensor]


class Graph(NamedTuple):
    """Edge-list graph with static shapes. Padded edges point at node
    ``n_nodes-1`` with edge_mask=False. Batched graphs carry a leading
    batch axis on every leaf."""
    features: torch.Tensor     # (N, F)
    src: torch.Tensor          # (E,) int
    dst: torch.Tensor          # (E,) int
    edge_mask: torch.Tensor    # (E,) bool
    labels: torch.Tensor       # (N,) int
    label_mask: torch.Tensor   # (N,) bool: which nodes contribute to the loss


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def param_shapes(cfg: GNNConfig, d_feat: int, n_classes: int
                 ) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Each parameter's shape and the scale of its N(0, 1) draw. Layer i:
    in -> (heads, hidden); the final layer: its heads averaged -> classes."""
    dims_in = [d_feat] + [cfg.d_hidden * cfg.n_heads] * (cfg.n_layers - 1)
    dims_out = [cfg.d_hidden] * (cfg.n_layers - 1) + [n_classes]
    out = {}
    for i in range(cfg.n_layers):
        h, o = cfg.n_heads, dims_out[i]
        out[f"layers/{i}/w"] = ((dims_in[i], h, o), dims_in[i] ** -0.5)
        out[f"layers/{i}/a_src"] = ((h, o), o ** -0.5)
        out[f"layers/{i}/a_dst"] = ((h, o), o ** -0.5)
    return out


def init_gat(seed: int, cfg: GNNConfig, d_feat: int, n_classes: int, *,
             device: Device = None) -> Params:
    """The reference's shapes and scales, drawn from a ``torch.Generator``
    on the device seeded with ``seed`` (the reference draws from a JAX
    key: carry its weights across with ``params_from_numpy`` for equal
    values). Runs on cuda unless ``device`` says otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: torch.randn(shape, generator=gen, device=dev).mul_(scale)
            for k, (shape, scale) in param_shapes(cfg, d_feat,
                                                  n_classes).items()}


def params_from_numpy(cfg: GNNConfig, d_feat: int, n_classes: int,
                      flat: Dict[str, np.ndarray], *,
                      device: Device = None) -> Params:
    """The flat, path-keyed numpy leaves of a GAT in the reference's
    checkpoint form (``repro/train/checkpoint.py``) as the port's
    parameters; keys and shapes must be the config's."""
    return common.params_from_numpy(
        flat, {k: s for k, (s, _) in param_shapes(cfg, d_feat,
                                                  n_classes).items()},
        name=cfg.name, device=resolve_device(device))


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _layer(params: Params, i: int) -> Params:
    pre = f"layers/{i}/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def _n_layers(params: Params) -> int:
    return 1 + max(int(k.split("/")[1]) for k in params
                   if k.startswith("layers/"))


# ---------------------------------------------------------------------------
# One GAT layer (edge-softmax attention aggregation)
# ---------------------------------------------------------------------------

def edge_segments(src: torch.Tensor, dst: torch.Tensor, n_nodes: int
                  ) -> Tuple[Segments, Segments]:
    """The edges grouped by source and by destination node, shared by
    every layer over the same edge list."""
    return Segments(src, n_nodes), Segments(dst, n_nodes)


def gat_layer(p: Params, x: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor, edge_mask: torch.Tensor, n_nodes: int, *,
              negative_slope: float, concat_heads: bool,
              segments: Optional[Tuple[Segments, Segments]] = None
              ) -> torch.Tensor:
    # The reference's three ``constrain`` calls pin the node axis over
    # the data axes. On a train mesh the port keeps every process's graph
    # whole: the edge gathers and the segment reductions read any node,
    # so each data process computes the whole node axis, as on one card
    # (the parameters are replicated, ``rules.gnn_specs``); a batch of
    # graphs splits over the data axes instead (``gat_batched_loss``).
    by_src, by_dst = segments or edge_segments(src, dst, n_nodes)
    fi, heads, d = p["w"].shape
    h = (x @ p["w"].reshape(fi, heads * d)).reshape(n_nodes, heads, d)
    h = constrain(h, "dp", None, None)
    e_src = (h * p["a_src"][None]).sum(-1)                # (N, H) src scores
    e_dst = (h * p["a_dst"][None]).sum(-1)
    # SDDMM: per-edge attention logits
    logits = gather(e_src, by_src) + gather(e_dst, by_dst)   # (E, H)
    # jax.nn.leaky_relu's form: slope 1 at exactly 0 (F.leaky_relu's is
    # negative_slope there)
    logits = torch.where(logits >= 0, logits, negative_slope * logits)
    live = edge_mask[:, None]
    logits = torch.where(live, logits, torch.full_like(logits, -1e30))
    # segment softmax over incoming edges of each dst node; an empty
    # segment's max is -inf and becomes 0, a node with no live edge gets
    # zeros (its denominator floored at 1e-16)
    seg_max = segment_max(logits, by_dst)                 # (N, H)
    seg_max = constrain(seg_max, "dp", None)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ex = torch.exp(logits - seg_max.index_select(0, by_dst.index)) * live
    denom = segment_sum(ex, by_dst)                       # (N, H)
    alpha = ex / torch.clamp(gather(denom, by_dst), min=1e-16)   # (E, H)
    # SpMM: weighted scatter of src messages into dst
    msg = gather(h, by_src) * alpha[..., None]            # (E, H, D)
    out = segment_sum(msg, by_dst)                        # (N, H, D)
    out = constrain(out, "dp", None, None)   # the scatter lands node-sharded
    if concat_heads:
        return F.elu(out.reshape(n_nodes, -1))
    return out.mean(dim=1)                                # final layer: avg heads


def _layers(params: Params, cfg: GNNConfig, x, src, dst, edge_mask, n):
    segs = edge_segments(src, dst, n)
    n_layers = _n_layers(params)
    for i in range(n_layers):
        x = gat_layer(_layer(params, i), x, src, dst, edge_mask, n,
                      negative_slope=cfg.negative_slope,
                      concat_heads=i < n_layers - 1, segments=segs)
    return x


def gat_forward(params: Params, cfg: GNNConfig, g: Graph) -> torch.Tensor:
    """Returns per-node class logits (N, n_classes)."""
    return _layers(params, cfg, g.features, g.src, g.dst, g.edge_mask,
                   g.features.shape[0])


def gat_loss(params: Params, cfg: GNNConfig, g: Graph) -> torch.Tensor:
    logits = gat_forward(params, cfg, g)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, g.labels.long()[:, None])[:, 0]
    mask = g.label_mask.to(logits.dtype)
    per_node = (logz - gold) * mask
    return per_node.sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Batched small graphs (molecule regime)
# ---------------------------------------------------------------------------

def gat_batched_loss(params: Params, cfg: GNNConfig, gb: Graph
                     ) -> torch.Tensor:
    """gb leaves have a leading batch dim; graph-level labels live in
    gb.labels[:, 0] (readout = mean over nodes). The reference's
    ``jax.vmap`` becomes one graph of B disjoint parts: node ids are
    offset by graph, so each node's segment holds the same edges in the
    same order, and the readout averages each graph's nodes."""
    B, n, f = gb.features.shape
    off = (torch.arange(B, device=gb.src.device) * n)[:, None]
    x = _layers(params, cfg, gb.features.reshape(B * n, f),
                (gb.src.long() + off).reshape(-1),
                (gb.dst.long() + off).reshape(-1),
                gb.edge_mask.reshape(-1), B * n)
    graph_logit = x.reshape(B, n, -1).mean(dim=1)         # (B, n_classes)
    logz = torch.logsumexp(graph_logit, dim=-1)
    gold = graph_logit.gather(-1, gb.labels[:, :1].long())[:, 0]
    return (logz - gold).mean()
