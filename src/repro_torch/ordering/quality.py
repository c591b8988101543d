"""Crawl-ordering QUALITY metrics — "did the important pages come first?"
Port copy of ``repro/ordering/quality.py`` (numpy; the canonical pages and
their importance come from the port's ``webgraph`` on the CPU).

An ordering policy cannot change how many pages a fixed step budget fetches
by much; what it changes is WHICH pages, and WHEN. Two host-side metrics
capture that (both computable from a CrawlReport, no extra device work):

  * importance-weighted coverage — every canonical page earns its true
    importance (the synthetic web's popularity) the first time it is
    fetched; ``coverage_curve`` is the cumulative importance after each
    step. Its endpoint (``importance_mass``) says how much importance the
    budget captured; ``coverage_auc`` (mean of the curve normalized by the
    endpoint, in (0, 1]) says how FRONT-LOADED the capture was — 1.0 means
    everything arrived at step one.
  * hot-page recall — fraction of a reference "hot set" fetched. The
    benchmarks build the reference by pooling every raced policy's fetched
    hub pages (:func:`pooled_hot_set`, the standard pooled-relevance trick);
    standalone reports count hub fetches instead.

Surfaced as ``CrawlReport.ordering_quality`` and raced per policy by
the JAX package's benchmarks/ordering.py.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.core import webgraph as W

HOT_THRESHOLD = 0.95        # webgraph.is_hub's hub percentile


def _canon_importance(urls: np.ndarray, cfg):
    """(canonical page uint32, its popularity as f64) of each URL."""
    u = torch.from_numpy(np.asarray(urls).astype(np.uint32).astype(np.int64))
    canon = W.canonical(u, cfg)
    imp = W.popularity(canon, cfg).numpy().astype(np.float64)
    return canon.numpy().astype(np.uint32), imp


def coverage_curve(urls: np.ndarray, per_step: np.ndarray, cfg) -> np.ndarray:
    """Cumulative first-fetch importance after each step -> (steps,) f64."""
    per_step = np.asarray(per_step, np.int64)
    if len(urls) == 0:
        return np.zeros(len(per_step))
    canon, imp = _canon_importance(urls, cfg)
    gain = np.zeros(len(canon))
    _, first = np.unique(canon, return_index=True)
    gain[first] = imp[first]
    step_of = np.repeat(np.arange(len(per_step)), per_step)
    return np.cumsum(np.bincount(step_of, weights=gain,
                                 minlength=len(per_step)))


def ordering_quality(urls: np.ndarray, per_step: np.ndarray, cfg, *,
                     hot_threshold: float = HOT_THRESHOLD) -> Dict[str, float]:
    """The standalone per-run metric bundle (see module docstring)."""
    if len(urls) == 0:
        return dict(importance_mass=0.0, coverage_auc=0.0,
                    unique_pages=0, hot_pages=0)
    curve = coverage_curve(urls, per_step, cfg)
    canon, imp = _canon_importance(urls, cfg)
    uniq, first = np.unique(canon, return_index=True)
    return dict(
        importance_mass=float(curve[-1]),
        coverage_auc=float(curve.mean() / max(curve[-1], 1e-12)),
        unique_pages=int(len(uniq)),
        hot_pages=int((imp[first] > hot_threshold).sum()),
    )


def pooled_hot_set(url_lists: Iterable[np.ndarray], cfg, *,
                   hot_threshold: float = HOT_THRESHOLD) -> np.ndarray:
    """Union of hub-grade canonical pages fetched by ANY run in the pool —
    the shared reference for :func:`hot_page_recall`."""
    hot = []
    for urls in url_lists:
        if len(urls) == 0:
            continue
        canon, imp = _canon_importance(np.asarray(urls), cfg)
        hot.append(np.unique(canon[imp > hot_threshold]))
    return (np.unique(np.concatenate(hot)) if hot
            else np.array([], np.uint32))


def hot_page_recall(urls: np.ndarray, cfg,
                    reference: Optional[np.ndarray] = None, *,
                    hot_threshold: float = HOT_THRESHOLD) -> float:
    """Fraction of the reference hot set this run fetched (1.0 when the
    reference is empty — nothing to miss)."""
    if reference is None or len(reference) == 0:
        return 1.0
    if len(urls) == 0:
        return 0.0
    canon, _ = _canon_importance(np.asarray(urls), cfg)
    return float(len(np.intersect1d(np.unique(canon), reference))
                 / len(reference))
