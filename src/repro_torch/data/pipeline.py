"""Crawl -> training-data pipeline. Counterpart of
``repro/data/pipeline.py``.

The crawled collection feeds model training: the synthetic web's pages
yield token streams (the LM family), URL features with a popularity
target (a learned ranker) and the link graph (GNN). Page content is
hash-derived from the URL (``webgraph.page_tokens``), so tokens are made on
the device from the fetched URL ids. Integer outputs equal the reference's
bit for bit. Everything runs on cuda unless ``device`` says otherwise.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import webgraph as W
from repro_torch.device import Device, resolve_device


def _urls(fetched_urls: np.ndarray, device: Device) -> torch.Tensor:
    """uint32 URL ids as the int64 tensor ``webgraph`` computes on."""
    return torch.from_numpy(np.asarray(fetched_urls).astype(np.uint32)
                            .astype(np.int64)).to(resolve_device(device))


def pages_to_tokens(urls: torch.Tensor, cfg: CrawlConfig, *,
                    tokens_per_page: int, vocab: int) -> torch.Tensor:
    """(N,) fetched URLs -> (N, tokens_per_page) int32 token matrix."""
    return W.page_tokens(urls, cfg, n_tokens=tokens_per_page, vocab=vocab)


def lm_batches(fetched_urls: np.ndarray, cfg: CrawlConfig, *, batch: int,
               seq_len: int, vocab: int, drop_last: bool = True,
               device: Device = None
               ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Pack crawled pages into (tokens, labels) LM batches, (batch,
    seq_len) int32 each. Pages of ``seq_len // 4`` tokens are concatenated
    into a stream and chunked to seq_len + 1; labels are the stream shifted
    by one (next-token prediction). Only whole batches are yielded, as the
    reference yields them whatever ``drop_last`` says."""
    toks = pages_to_tokens(_urls(fetched_urls, device), cfg,
                           tokens_per_page=seq_len // 4,
                           vocab=vocab).reshape(-1)
    n_seq = toks.numel() // (seq_len + 1)
    toks = toks[: n_seq * (seq_len + 1)].reshape(n_seq, seq_len + 1)
    for i in range(0, n_seq - batch + 1, batch):
        chunk = toks[i: i + batch]
        yield chunk[:, :-1], chunk[:, 1:]


def crawl_edges(fetched_urls: np.ndarray, cfg: CrawlConfig, *,
                device: Device = None) -> Tuple[np.ndarray, np.ndarray]:
    """Link structure of the crawled set: (src, dst) int64 edge arrays for
    GNN training over the crawl graph."""
    urls = _urls(fetched_urls, device)
    outs = W.outlinks(urls, cfg, W.zipf_cumweights(cfg, urls.device))
    src = np.repeat(np.asarray(fetched_urls), outs.shape[1])
    return src.astype(np.int64), outs.reshape(-1).cpu().numpy()


def ranker_examples(fetched_urls: np.ndarray, cfg: CrawlConfig, *,
                    device: Device = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(features (N, 8), popularity target (N,)) pairs for training a
    learned URL ranker."""
    from repro_torch.core.ranker import url_features
    urls = _urls(fetched_urls, device)
    return url_features(urls, cfg), W.popularity(urls, cfg)
