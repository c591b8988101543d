"""The live query path: sharded incremental indexing and batched TF-IDF
serving. Counterpart of ``repro/serve/query.py``.

The index is ``n_shards`` independent ``Index`` blocks along a leading
axis of every leaf, as the crawl state's shards are, and each step below
runs once for all of them (no loop over shards). Under a crawl group a
rank holds its own shards' blocks (``index_specs``), and the reference's
collectives are the group's: ``psum`` of df and N an integer
``all_reduce``, and the winners' ``all_gather`` a gather in shard order,
so that every rank serves the same answers:

  * **incremental add** (:func:`make_index_add`): a dispatch interval's
    stacked FetchReport folds into the index, each shard's pages into its
    own block, in (step, row, lane) order;
  * **batched query** (:func:`make_query_fn`): a (B,)-batch of (seed,
    domain) descriptors is expanded to hashed terms on the device, scored
    against every block with GLOBAL corpus statistics (the JAX package's
    ``psum`` of df and N is a sum over the leading axis), top-k'd per
    block, and merged: its ``all_gather`` and global top-k are a
    transpose, a reshape and one top-k over the shard-major winners, so
    that ties across shards resolve as in the JAX package;
  * **oracle** (:func:`oracle_search`): the unsharded full-index
    reference that recall@k compares against.

Every top-k is a stable descending sort (``lax.top_k``'s ties to the lower
index).
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import index as IX
from repro_torch.core.stages import FetchReport
from repro_torch.dist import CrawlGroup


def init_sharded_index(n_shards: int, cap_shard: int, doc_len: int,
                       vocab: int, device=None) -> IX.Index:
    """An ``Index`` whose every leaf carries a leading (n_shards,) axis."""
    return IX.init_index(cap_shard, doc_len, vocab, blocks=n_shards,
                         device=device)


def index_specs(axes="data") -> IX.Index:
    """Which index leaves a crawl group splits: every one, along its
    leading shard axis (``axes``, as the reference's ``P(axes)``); a rank
    holds its own shards' blocks."""
    return IX.Index(*([axes] * len(IX.Index._fields)))


def make_index_add(cfg: CrawlConfig) -> Callable:
    """``(index, report) -> index``: fold one interval's fetched pages
    (FetchReport leaves ``(steps, n_slots, k)``) into each shard's block.
    A shard's pages are its own rows', flattened in (step, row, lane)
    order, so that per-interval adds equal one add of the whole stream."""
    def add(idx: IX.Index, rep: FetchReport) -> IX.Index:
        n = idx.n_docs.shape[0]

        def per_shard(a):
            steps, n_slots, k = a.shape
            return a.reshape(steps, n, n_slots // n, k).transpose(
                0, 1).reshape(n, -1)
        return IX.add_batch(idx, per_shard(rep.fetched_urls),
                            per_shard(rep.fetched_mask), cfg)

    return add


def make_query_fn(cfg: CrawlConfig, *, n_terms: int, k: int) -> Callable:
    """``(index, seeds (B,), domains (B,)) -> (scores, urls)``, each
    (B, k). Terms are generated on the device from the descriptors
    (``core/index.query_terms``)."""
    group = CrawlGroup.current()

    def query(idx: IX.Index, seeds: torch.Tensor, doms: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        n, cap = idx.doc_url.shape
        vocab = idx.df.shape[-1]
        # global corpus statistics: shard-local tf, corpus-wide idf (the
        # integer sums of every rank's blocks)
        df_g = group.sum_int(idx.df.sum(0, dtype=torch.int32))
        n_g = group.sum_int(idx.n_docs.sum(dtype=torch.int32))
        terms = IX.query_terms(seeds, n_terms, vocab, doms, cfg)   # (B, Q)
        B = terms.shape[0]
        scores = IX.score_docs(idx, terms[None], n_total=n_g, df=df_g)
        k_l = min(k, cap)
        s_l, i_l = IX.top_k(scores, k_l)                       # (n, B, k_l)
        u_l = torch.gather(idx.doc_url[:, None].expand(n, B, cap), 2, i_l)
        # every rank's winners, in shard order: (N, B, k_l)
        s_l, u_l = group.gather(s_l), group.gather(u_l)
        n = s_l.shape[0]
        # the shard winners, shard-major per query, then one global top-k
        s_cat = s_l.transpose(0, 1).reshape(B, n * k_l)
        u_cat = u_l.transpose(0, 1).reshape(B, n * k_l)
        if n * k_l < k:                           # tiny-index degenerate
            pad = k - n * k_l
            s_cat = torch.cat([s_cat, s_cat.new_full((B, pad),
                                                     float("-inf"))], 1)
            u_cat = torch.cat([u_cat, u_cat.new_zeros((B, pad))], 1)
        s_g, j = IX.top_k(s_cat, k)
        return s_g, torch.gather(u_cat, 1, j)

    return query


# ---------------------------------------------------------------------------
# the full-index oracle (recall@k reference)
# ---------------------------------------------------------------------------

def oracle_index(urls: np.ndarray, cfg: CrawlConfig, *, doc_len: int,
                 vocab: int, device=None) -> IX.Index:
    """One unsharded index over the COMPLETE page stream (capacity = all
    pages): what an offline build with no capacity pressure and no
    freshness lag would have served."""
    cap = max(len(urls), 1)
    idx = IX.init_index(cap, doc_len, vocab, device=device)
    u = torch.from_numpy(urls.astype(np.uint32).astype(np.int64)).to(device)
    return IX.add_batch(idx, u, torch.ones_like(u, dtype=torch.bool), cfg)


def oracle_search(idx: IX.Index, seeds: np.ndarray, doms: np.ndarray, *,
                  n_terms: int, k: int, cfg: CrawlConfig,
                  chunk: int = 64) -> np.ndarray:
    """Top-k urls (0-padded where fewer than k finite hits) per query,
    ``chunk`` queries at a time."""
    dev = idx.doc_url.device
    blocked = IX.Index(*(a[None] for a in idx))
    vocab = idx.df.shape[0]
    k_eff = min(k, idx.doc_valid.shape[0])
    out = []
    for lo in range(0, len(seeds), chunk):
        s = torch.from_numpy(seeds[lo:lo + chunk].astype(np.int64)).to(dev)
        d = torch.from_numpy(doms[lo:lo + chunk].astype(np.int64)).to(dev)
        terms = IX.query_terms(s, n_terms, vocab, d, cfg)
        sc, i = IX.top_k(IX.score_docs(blocked, terms[None])[0], k_eff)
        u = torch.where(torch.isfinite(sc), idx.doc_url[i],
                        torch.zeros_like(i))
        out.append(u.cpu().numpy().astype(np.uint32))
    return (np.concatenate(out) if out
            else np.zeros((0, k), np.uint32))


def recall_at_k(served: np.ndarray, oracle: np.ndarray) -> float:
    """Mean |served ∩ oracle| / |oracle| per query (0-padding excluded)."""
    if len(served) == 0:
        return 0.0
    r = []
    for s_row, o_row in zip(served, oracle):
        o = set(int(u) for u in o_row if u)
        if not o:
            continue
        s = set(int(u) for u in s_row if u)
        r.append(len(s & o) / len(o))
    return float(np.mean(r)) if r else 0.0
