"""Domain classification (paper §IV.B.3-4). Counterpart of
``repro/core/classifier.py``.

``page_domain`` is the page analyzer's exact post-fetch classifier;
``predict_domain`` is the dispatcher's pre-fetch guess, right with
probability ``accuracy`` and otherwise the source page's domain.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import webgraph as W

DEFAULT_ACCURACY = 0.9


def page_domain(urls: torch.Tensor, cfg: CrawlConfig) -> torch.Tensor:
    """Post-fetch classification — exact (content is in hand)."""
    return W.domain_of(urls, cfg)


def predict_domain(urls: torch.Tensor, src_domain: torch.Tensor,
                   cfg: CrawlConfig, *, step: Union[torch.Tensor, int] = 0,
                   accuracy: float = DEFAULT_ACCURACY) -> torch.Tensor:
    """Pre-fetch domain prediction for discovered URLs, keyed on
    (url, step) by a stateless hash."""
    u = W._uniform(W.hash2(urls, step, 51))
    truth = W.domain_of(urls, cfg)
    return torch.where(u < accuracy, truth, src_domain.to(torch.int64))
