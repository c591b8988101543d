"""URL-ordering policy registry. Counterpart of
``repro/ordering/policies.py``.

The stateless built-ins live here: ``fifo`` (one bucket, arrival order),
``backlink`` (the ranker's static blend, the default) and ``learned`` (a
fixed linear probe over ``ranker.url_features``); ``make_learned_ordering``
wraps a trained scorer as a policy. The stateful OPIC orderings, ``opic``
(ordering/opic.py) and ``opic_url`` (ordering/opic_url.py), register when
first resolved.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.core import ranker

# columns of CrawlState.order_state: col 0 slot cash, col 1 history (OPIC);
# stateless policies carry zeros. A url-lane policy appends
# frontier_capacity more columns from ORD_URL0 on.
ORD_WIDTH = 2
ORD_URL0 = ORD_WIDTH


class OrderingPolicy(NamedTuple):
    """One URL-ordering scheme, resolvable by name from ``cfg.ordering``.

      init_state     — (cfg, n_shards, device) -> (n_slots, ORD_WIDTH) f32,
                       or (n_slots, ORD_WIDTH + C) for a url-lane policy.
      make_score_fn  — (cfg, *, n_shards, shard) -> score_fn(urls, cfg,
                       state, val=None) mapping URLs to [0, 1) queue
                       scores; ``shard`` is the shard of each row of the
                       URLs (rows first), or one int.
      update_stage   — optional pipeline stage run before extract.
      url_lane       — the policy keeps per-URL state in order_state.
    """
    name: str
    stateful: bool
    init_state: Callable
    make_score_fn: Callable
    update_stage: Optional[Callable] = None
    url_lane: bool = False


_ORDERINGS: Dict[str, OrderingPolicy] = {}


def register_ordering(policy: OrderingPolicy) -> OrderingPolicy:
    """Register under ``policy.name`` (error on conflicting re-use)."""
    if policy.name in _ORDERINGS and _ORDERINGS[policy.name] is not policy:
        raise ValueError(f"ordering policy {policy.name!r} registered twice")
    _ORDERINGS[policy.name] = policy
    return policy


def orderings() -> Tuple[str, ...]:
    import repro_torch.ordering.opic_url  # noqa: F401  (registers both OPICs)
    return tuple(sorted(_ORDERINGS))


def get_ordering(name: str) -> OrderingPolicy:
    """Resolve a ``cfg.ordering`` string to its registered policy."""
    import repro_torch.ordering.opic_url  # noqa: F401  (registers both OPICs)
    if name not in _ORDERINGS:
        raise KeyError(f"unknown ordering policy {name!r}; "
                       f"registered: {orderings()}")
    return _ORDERINGS[name]


def as_score_fn(fn: Callable) -> Callable:
    """Adapt a stateless ``(urls, cfg)`` scorer to the state-aware
    ordering signature."""
    def score(urls, cfg, state, val=None):
        return fn(urls, cfg)
    return score


def zeros_state(cfg: CrawlConfig, n_shards: int, device) -> torch.Tensor:
    """order_state for stateless policies (kept zero by the stages)."""
    return torch.zeros((cfg.n_slots, ORD_WIDTH), dtype=torch.float32,
                       device=device)


def _backlink_score_fn(cfg, *, n_shards, shard=0):
    return as_score_fn(ranker.score_urls)


def _fifo_score_fn(cfg, *, n_shards, shard=0):
    def score(urls, cfg, state, val=None):
        # one bucket for every URL: the FIFO tie-break is the whole ordering
        return torch.full(urls.shape, 0.5, dtype=torch.float32,
                          device=urls.device)
    return score


# fixed weights over ranker.url_features (pop, hub, dom, 5 hash dims)
_LEARNED_W = (2.0, 0.8, 0.0, 0.25, 0.0, 0.0, 0.0, 0.0)
_LEARNED_B = -1.0


def _learned_score_fn(cfg, *, n_shards, shard=0):
    def score(urls, cfg, state, val=None):
        feats = ranker.url_features(urls, cfg)
        w = torch.tensor(_LEARNED_W, dtype=torch.float32, device=urls.device)
        s = torch.sigmoid(feats @ w + _LEARNED_B)
        return torch.clamp(s, 0.0, 0.999)
    return score


def make_learned_ordering(apply_fn: Callable, params,
                          name: str = "learned_custom") -> OrderingPolicy:
    """Wrap a trained model (apply_fn(params, features) -> [0, 1) scores)
    as a registrable ordering policy: ``register_ordering`` it, then
    select it by name through ``CrawlConfig.ordering``."""
    scorer = ranker.make_learned_scorer(apply_fn, params)

    def make_score_fn(cfg, *, n_shards, shard=0):
        return as_score_fn(scorer)

    return OrderingPolicy(name, False, zeros_state, make_score_fn)


FIFO = register_ordering(OrderingPolicy(
    "fifo", False, zeros_state, _fifo_score_fn))
BACKLINK = register_ordering(OrderingPolicy(
    "backlink", False, zeros_state, _backlink_score_fn))
LEARNED = register_ordering(OrderingPolicy(
    "learned", False, zeros_state, _learned_score_fn))
