"""Fanout neighbour sampler for large-graph GNN minibatch training
(GraphSAGE-style, the ``minibatch_lg`` shape). Port copy of
``repro/data/sampler.py`` (numpy on the host; the same arrays bit for bit
for the same seed and ``rng``).

The sampler is host-side data loading over CSR; the sampled block is
padded to static shapes. Synthetic graphs are generated on demand with a
power-law-ish degree profile, so the sampler meets a realistic degree
skew without a 115M-edge dataset in the repo.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class CSRGraph(NamedTuple):
    indptr: np.ndarray     # (N+1,) int64
    indices: np.ndarray    # (E,) int32
    n_nodes: int


class SampledBlock(NamedTuple):
    """A fanout-sampled computation block, padded to static shapes.

    ``node_ids`` holds the block's nodes in ascending id order (so seeds
    with the lowest ids come first); features/labels are indexed by
    position in ``node_ids``. Edges are (src_pos, dst_pos) into
    ``node_ids``. Padded edges have mask False.
    """
    node_ids: np.ndarray   # (max_nodes,) int32, padded with -1
    n_valid_nodes: int
    src: np.ndarray        # (max_edges,) int32 positions
    dst: np.ndarray
    edge_mask: np.ndarray  # (max_edges,) bool


def synthetic_csr(n_nodes: int, avg_degree: int, seed: int = 0) -> CSRGraph:
    """Power-law-ish synthetic graph in CSR (preferential-attachment
    flavour)."""
    rng = np.random.default_rng(seed)
    # degree ~ clipped Pareto around avg_degree
    deg = np.minimum(
        (rng.pareto(1.5, n_nodes) + 1.0) * (avg_degree / 3.0), avg_degree * 50
    ).astype(np.int64)
    deg = np.maximum(deg, 1)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    # endpoints biased toward low ids (hubs)
    e = int(indptr[-1])
    u = rng.random(e)
    indices = (n_nodes * u ** 2.0).astype(np.int32)  # quadratic bias -> hubs
    return CSRGraph(indptr, indices, n_nodes)


def sample_fanout(g: CSRGraph, seeds: np.ndarray, fanouts: Tuple[int, ...],
                  *, rng: np.random.Generator) -> SampledBlock:
    """Multi-hop fanout sampling. Returns one merged block (all hops'
    edges), for a GAT whose every layer sees the same block: the standard
    full-neighbourhood-union formulation."""
    n_seeds = len(seeds)
    frontier = seeds.astype(np.int32)
    all_nodes = [frontier]
    edges_src: list[np.ndarray] = []
    edges_dst: list[np.ndarray] = []
    for fanout in fanouts:
        starts = g.indptr[frontier]
        degs = g.indptr[frontier + 1] - starts
        # sample `fanout` neighbours per frontier node (with replacement
        # where degree < fanout: standard GraphSAGE behaviour)
        offs = (rng.random((len(frontier), fanout)) *
                np.maximum(degs, 1)[:, None]).astype(np.int64)
        nbrs = g.indices[(starts[:, None] + offs).reshape(-1)]
        nbrs = np.where(np.repeat(degs, fanout) > 0, nbrs,
                        np.repeat(frontier, fanout))
        edges_src.append(nbrs.astype(np.int32))
        edges_dst.append(np.repeat(frontier, fanout).astype(np.int32))
        frontier = np.unique(nbrs).astype(np.int32)
        all_nodes.append(frontier)

    nodes = np.unique(np.concatenate(all_nodes))
    # relabel edges into block-local positions: ``nodes`` is sorted and
    # unique, so a binary search gives the reference's lookup table's
    # positions
    src = np.searchsorted(nodes, np.concatenate(edges_src)).astype(np.int32)
    dst = np.searchsorted(nodes, np.concatenate(edges_dst)).astype(np.int32)

    max_nodes = _block_max_nodes(n_seeds, fanouts)
    max_edges = _block_max_edges(n_seeds, fanouts)
    node_ids = np.full(max_nodes, -1, np.int32)
    node_ids[: len(nodes)] = nodes
    psrc = np.zeros(max_edges, np.int32)
    pdst = np.full(max_edges, max(len(nodes) - 1, 0), np.int32)
    mask = np.zeros(max_edges, bool)
    psrc[: len(src)] = src
    pdst[: len(dst)] = dst
    mask[: len(src)] = True
    return SampledBlock(node_ids, len(nodes), psrc, pdst, mask)


def _block_max_nodes(n_seeds: int, fanouts: Tuple[int, ...]) -> int:
    n, tot = n_seeds, n_seeds
    for f in fanouts:
        n = n * f
        tot += n
    return tot


def _block_max_edges(n_seeds: int, fanouts: Tuple[int, ...]) -> int:
    n, tot = n_seeds, 0
    for f in fanouts:
        tot += n * f
        n = n * f
    return tot
