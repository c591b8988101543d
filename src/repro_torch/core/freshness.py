"""Revisit scheduling: the crawler's second goal, observing changes in
pages already discovered. Counterpart of ``repro/core/freshness.py``.

Fetched URLs re-enter their domain's queue at an age-discounted score, so
that the allocator interleaves revisits with discovery. A page "changes"
when ``change_epoch(url, t)`` advances, at a rate tied to its popularity
(popular pages change faster), and its content with it
(``page_tokens_versioned``).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import frontier as F
from repro_torch.core import webgraph as W


def change_period(url: torch.Tensor, cfg: CrawlConfig, *, base: int = 32
                  ) -> torch.Tensor:
    """Steps between content changes (int32): popular pages change ~4x
    faster."""
    pop = W.popularity(url, cfg)
    return torch.clamp((base * (1.25 - pop)).to(torch.int32), min=4)


def change_epoch(url: torch.Tensor, step: Union[torch.Tensor, int],
                 cfg: CrawlConfig) -> torch.Tensor:
    """Monotone counter that bumps when the page's content changes."""
    step = torch.as_tensor(step, dtype=torch.int32, device=url.device)
    return torch.div(step, change_period(url, cfg),
                     rounding_mode="floor").to(torch.int32)


def page_tokens_versioned(url: torch.Tensor, step: Union[torch.Tensor, int],
                          cfg: CrawlConfig, *, n_tokens: int,
                          vocab: int) -> torch.Tensor:
    """Epoch-salted content: the same page has new text after each
    change. (..., ) -> (..., n_tokens) int32."""
    epoch = change_epoch(url, step, cfg).to(torch.int64)
    return W.page_tokens(W.hash2(url, epoch, 71), cfg, n_tokens=n_tokens,
                         vocab=vocab)


def revisit_score(url: torch.Tensor, age_steps: torch.Tensor,
                  cfg: CrawlConfig) -> torch.Tensor:
    """Priority for re-enqueueing a fetched URL: grows with expected
    staleness (age / change_period), capped below fresh-discovery scores
    so that discovery wins when the frontier is hot."""
    staleness = age_steps.to(torch.float32) / change_period(url, cfg)
    return torch.clamp(0.15 + 0.5 * torch.tanh(staleness - 0.5), 0.0, 0.8)


def reenqueue(fr: F.Frontier, urls: torch.Tensor, mask: torch.Tensor,
              age_steps: torch.Tensor, cfg: CrawlConfig) -> F.Frontier:
    """Put fetched URLs back at their revisit priority (after the fetch)."""
    scores = revisit_score(urls, age_steps, cfg)
    return F.insert(fr, urls, scores, mask, n_buckets=cfg.n_priority_buckets)
