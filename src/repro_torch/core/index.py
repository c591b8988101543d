"""The search-engine side of the cascade (paper Fig. 1: crawl -> index ->
search). Counterpart of ``repro/core/index.py``.

A fixed-capacity, device-resident bag-of-words index over hashed terms,
filled in BATCHES (the paper's §IV.B.4: the index is rebuilt at intervals,
not continuously). Documents are the crawler's fetched pages, their terms
``webgraph.page_tokens``. Scoring is TF-IDF against the doc-token matrix:
a term's count in a doc comes from binary searches of the doc's sorted
tokens (the JAX module compares every token with every term).

Every function also takes an index whose leaves carry one leading axis of
blocks (``serve/query.py``'s shards: ``doc_url`` (n, capacity), ``n_docs``
(n,), ...), with the URLs, masks and queries batched along the same axis;
a block sees only its own rows. URLs are int64 holding uint32 values.

Where the JAX package's f32 arithmetic is not correctly rounded, this one
is, so that every device gives the same bits: ``log1p`` is taken in f64
and rounded to f32 (XLA's CPU ``log1p`` differs by a few ulps), and the
sum over the query terms adds them left to right. Integers stay integers:
the cumulative positions, the sacrificial row ``capacity`` that refused
documents are written to, ``n_dropped`` and the document-frequency
scatter-add (deterministic on the card, unlike an f32 one).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import webgraph as W


class Index(NamedTuple):
    doc_url: torch.Tensor      # (capacity,) int64 uint32 ids, 0 = empty
    doc_tokens: torch.Tensor   # (capacity, doc_len) int32 hashed terms
    doc_valid: torch.Tensor    # (capacity,) bool
    n_docs: torch.Tensor       # () int32
    df: torch.Tensor           # (vocab,) int32 document frequencies
    n_dropped: torch.Tensor    # () int32 docs refused at capacity


def init_index(capacity: int, doc_len: int, vocab: int, *,
               blocks: Optional[int] = None, device=None) -> Index:
    """An empty index; with ``blocks`` every leaf has that leading axis."""
    lead = () if blocks is None else (blocks,)

    def zeros(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return Index(doc_url=zeros((capacity,), torch.int64),
                 doc_tokens=zeros((capacity, doc_len), torch.int32),
                 doc_valid=zeros((capacity,), torch.bool),
                 n_docs=zeros((), torch.int32),
                 df=zeros((vocab,), torch.int32),
                 n_dropped=zeros((), torch.int32))


def _blocked(idx: Index) -> Tuple[Index, bool]:
    """The index with a leading block axis, and whether it had one."""
    if idx.n_docs.dim() == 1:
        return idx, True
    return Index(*(a[None] for a in idx)), False


def _unblocked(idx: Index, had: bool) -> Index:
    return idx if had else Index(*(a[0] for a in idx))


def add_batch(idx: Index, urls: torch.Tensor, mask: torch.Tensor,
              cfg: CrawlConfig) -> Index:
    """Batch index update: urls/mask (M,), or (n, M) for a blocked index.

    Documents beyond capacity are masked out (the oldest are kept): their
    writes land in a sacrificial row past the live range, so that a full
    index never wraps or overwrites a doc, and every refused doc is
    counted in ``n_dropped``. Sequential adds equal one add of the
    concatenated stream, bit for bit. Returns a new index."""
    ix, had = _blocked(idx)
    if not had:
        urls, mask = urls[None], mask[None]
    n, cap = ix.doc_url.shape
    doc_len, vocab = ix.doc_tokens.shape[-1], ix.df.shape[-1]
    urls = urls.to(torch.int64)
    toks = W.page_tokens(urls, cfg, n_tokens=doc_len, vocab=vocab)

    pos = ix.n_docs[:, None].to(torch.int64) + torch.cumsum(
        mask.to(torch.int64), dim=1) - 1
    fits = mask & (pos < cap)
    pos_safe = torch.where(fits, pos, torch.full_like(pos, cap))
    rows = torch.arange(n, device=urls.device)[:, None]

    def put(arr, vals):
        ext = torch.cat([arr, torch.zeros_like(arr[:, :1])], dim=1)
        keep = fits.reshape(fits.shape + (1,) * (vals.dim() - 2))
        vals = vals.to(arr.dtype)
        ext[rows, pos_safe] = torch.where(keep, vals, torch.zeros_like(vals))
        return ext[:, :cap]

    # document frequencies: each term once per doc, an integer scatter-add
    sorted_t = torch.sort(toks, dim=-1).values
    first = torch.ones_like(sorted_t, dtype=torch.bool)
    first[..., 1:] = sorted_t[..., 1:] != sorted_t[..., :-1]
    contrib = (first & fits[..., None]).to(torch.int32)
    df = ix.df.clone().scatter_add_(
        1, sorted_t.reshape(n, -1).to(torch.int64), contrib.reshape(n, -1))

    out = Index(
        doc_url=put(ix.doc_url, urls),
        doc_tokens=put(ix.doc_tokens, toks),
        doc_valid=put(ix.doc_valid, fits) | ix.doc_valid,
        n_docs=ix.n_docs + fits.sum(1).to(torch.int32),
        df=df,
        n_dropped=ix.n_dropped + (mask & ~fits).sum(1).to(torch.int32))
    return _unblocked(out, had)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """``log1p`` of an f32 tensor, correctly rounded to f32 (taken in
    f64): the same bits on every device."""
    return torch.log1p(x.to(torch.float64)).to(torch.float32)


def _scores(tokens: torch.Tensor, valid: torch.Tensor, idf: torch.Tensor,
            terms: torch.Tensor) -> torch.Tensor:
    """tokens (n, D, L), valid (n, D), terms and idf (n, B, Q) ->
    (n, B, D) f32 TF-IDF scores, -inf for invalid docs.

    tf is counted by two binary searches of each term in the doc's
    sorted tokens (no (D, L, Q) match tensor); log1p(tf) comes from one
    correctly rounded table of every possible count, and the terms add
    left to right."""
    n, D, L = tokens.shape
    B, Q = terms.shape[1:]
    srt = torch.sort(tokens, dim=-1).values
    v = terms.to(tokens.dtype).reshape(n, 1, B * Q).expand(
        n, D, B * Q).contiguous()
    tf = (torch.searchsorted(srt, v, right=True, out_int32=True)
          - torch.searchsorted(srt, v, out_int32=True))    # (n, D, B * Q)
    table = log1p_f32(torch.arange(L + 1, dtype=torch.float32,
                                   device=tokens.device))
    w = table[tf.view(n, D, B, Q).transpose(1, 2)]           # (n, B, D, Q)
    out = w[..., 0] * idf[:, :, 0, None]
    for q in range(1, Q):
        out = out + w[..., q] * idf[:, :, q, None]
    return torch.where(valid[:, None], out,
                       torch.full_like(out, float("-inf")))


def _idf(n_total: torch.Tensor, df_terms: torch.Tensor) -> torch.Tensor:
    """idf = log1p(N / (1 + df)) with N = max(n_total, 1), in f32."""
    N = torch.clamp(n_total.to(torch.float32), min=1.0)
    return log1p_f32(N / (1.0 + df_terms.to(torch.float32)))


def score_docs(idx: Index, query: torch.Tensor, *,
               n_total: Optional[torch.Tensor] = None,
               df: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-doc TF-IDF scores: (Q,) terms -> (capacity,), or for a blocked
    index (n or 1, B, Q) -> (n, B, capacity).

    tf(d, t) = count of t in doc d; idf(t) = log(1 + N / (1 + df[t])).
    ``n_total`` / ``df`` override the block's doc count and document
    frequencies with global ones (the sharded query path scores each
    shard against corpus-wide statistics)."""
    ix, had = _blocked(idx)
    n = ix.df.shape[0]
    terms = query.to(torch.int64)
    if not had:
        terms = terms[None, None]
    terms = terms.expand(n, *terms.shape[1:])
    N = ix.n_docs if n_total is None else n_total
    dfreq = ix.df if df is None else df
    if dfreq.dim() == 1:
        dfreq = dfreq.expand(n, -1)
    N = N.reshape(-1, 1, 1).expand(n, 1, 1)
    df_terms = torch.gather(dfreq, 1, terms.reshape(n, -1)).reshape(
        terms.shape)
    scores = _scores(ix.doc_tokens, ix.doc_valid, _idf(N, df_terms),
                     terms.to(torch.int32))
    return scores if had else scores[0, 0]


def top_k(scores: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest, ties to the lower
    index (a stable descending sort)."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def search(idx: Index, query: torch.Tensor, *, k: int = 10
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TF-IDF retrieval on one index: (Q,) terms -> (scores, urls) top-k."""
    scores = score_docs(idx, query)
    s, i = top_k(scores, min(k, scores.shape[0]))
    return s, idx.doc_url[i]


def query_terms(text_seed, n_terms: int, vocab: int, domain,
                cfg: CrawlConfig) -> torch.Tensor:
    """Synthetic query generator: terms drawn from a domain's token band.
    ``text_seed`` and ``domain`` are ints, or (B,) tensors -> (B, Q)."""
    band = vocab // max(int(cfg.n_domains), 1)
    seed = torch.as_tensor(text_seed, dtype=torch.int64)
    dom = torch.as_tensor(domain, dtype=torch.int64, device=seed.device)
    i = torch.arange(n_terms, dtype=torch.int64, device=seed.device)
    h = W.hash2(seed[..., None].expand(seed.shape + (n_terms,)), i, 91)
    return (dom[..., None] * band + h % max(band, 1)).to(torch.int32)
