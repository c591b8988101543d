"""URL ranker (paper §IV.A.2) — relevance scoring for the prioritized
queues. Counterpart of ``repro/core/ranker.py``.

A learned scorer (``make_learned_scorer``) can replace the hand-crafted
blend: ``score_fn`` is pluggable."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import webgraph as W


def score_urls(urls: torch.Tensor, cfg: CrawlConfig, *,
               request_count: Optional[torch.Tensor] = None,
               w_pop: float = 0.7, w_hub: float = 0.2,
               w_req: float = 0.1) -> torch.Tensor:
    """Relevance in [0, 1). Elementwise over any shape; each product and
    sum is rounded to f32 on its own, as XLA computes it."""
    pop = W.popularity(urls, cfg)
    hub = W.is_hub(urls, cfg).to(torch.float32)
    req = (torch.zeros_like(pop) if request_count is None else
           torch.clamp(request_count.to(torch.float32) / 16.0, max=1.0))
    s = w_pop * pop + w_hub * hub + w_req * req
    return torch.clamp(s, 0.0, 0.999)


def make_learned_scorer(apply_fn: Callable, params) -> Callable:
    """Wrap a model over URL features as a frontier scorer:
    apply_fn(params, features (..., 8)) -> scores, clipped to [0, 0.999]."""
    def scorer(urls: torch.Tensor, cfg: CrawlConfig, **_) -> torch.Tensor:
        feats = url_features(urls, cfg)
        return torch.clamp(apply_fn(params, feats), 0.0, 0.999)
    return scorer


def url_features(urls: torch.Tensor, cfg: CrawlConfig) -> torch.Tensor:
    """Static per-URL feature vector (8 dims) for learned scorers."""
    pop = W.popularity(urls, cfg)
    hub = W.is_hub(urls, cfg).to(torch.float32)
    dom = W.domain_of(urls, cfg).to(torch.float32) / cfg.n_domains
    h = [W._uniform(W.hash2(urls, s)) for s in (41, 42, 43, 44, 45)]
    return torch.stack([pop, hub, dom, *h], dim=-1)
