"""Synthetic query-load generator — the traffic the serve layer is built for.
Port copy of ``repro/serve/load.py`` (numpy; the same schedule bit for bit).

Open-loop arrivals: queries arrive on their own schedule whether or not the
server keeps up (the honest way to measure tail latency — a closed loop
self-throttles and hides queueing). The schedule lives in CRAWL-STEP time:
``qps`` is queries per crawl step, and the serve session maps each arrival
into the wall-clock window its interval actually took.

Three knobs shape the mix (DESIGN.md §16):

  * **Zipfian query popularity** — query domains are drawn from a
    ``1/rank^zipf_q`` distribution over the config's topical domains, the
    classic search-traffic skew (a few head topics dominate).
  * **Bursty arrivals** — time is cut into ``burst_len``-step blocks; each
    block independently bursts with probability ``burst_prob``, multiplying
    the Poisson arrival rate by ``burst_mult``. Open-loop bursts are what
    stress the p99.
  * **Seeded, seekable determinism** — every step's arrivals come from
    ``np.random.default_rng([seed, step])`` (and blocks from
    ``[seed, _BLOCK_SALT, block]``), so the schedule is a pure function of
    ``(seed, params)``: two generators agree bit-for-bit, any horizon is
    reachable lazily, and a restored session resumes mid-schedule from just
    a cursor (no RNG state to checkpoint).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.configs.base import CrawlConfig

_BLOCK_SALT = 0x6275       # "bu"(rst) — separates block draws from step draws


@dataclass(frozen=True)
class QueryBatch:
    """Arrivals handed to the serve session: parallel per-query arrays."""
    time: np.ndarray         # (n,) float64 arrival time in crawl-step units
    domain: np.ndarray       # (n,) int32 query topic (Zipf-skewed)
    seed: np.ndarray         # (n,) uint32 per-query text seed
    cursor: int              # schedule position AFTER these arrivals

    def __len__(self) -> int:
        return len(self.time)


class QueryLoad:
    """Deterministic open-loop query schedule over a crawl's step clock."""

    def __init__(self, cfg: CrawlConfig, *, qps: float = 4.0,
                 zipf_q: float = 1.1, seed: int = 0,
                 burst_prob: float = 0.08, burst_len: int = 8,
                 burst_mult: float = 6.0):
        if qps < 0:
            raise ValueError(f"qps must be >= 0, got {qps}")
        self.cfg = cfg
        self.qps = float(qps)
        self.seed = int(seed)
        self.burst_prob = float(burst_prob)
        self.burst_len = max(int(burst_len), 1)
        self.burst_mult = float(burst_mult)
        ranks = np.arange(1, cfg.n_domains + 1, dtype=np.float64)
        w = ranks ** -float(zipf_q)
        self._probs = w / w.sum()
        # lazily materialized flat schedule (grown step by step)
        self._time = np.empty(0, np.float64)
        self._domain = np.empty(0, np.int32)
        self._seed = np.empty(0, np.uint32)
        self._steps_done = 0

    # -- the deterministic schedule ----------------------------------------

    def _bursting(self, step: int) -> bool:
        block = step // self.burst_len
        rng = np.random.default_rng([self.seed, _BLOCK_SALT, block])
        return bool(rng.random() < self.burst_prob)

    def _step_arrivals(self, step: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = np.random.default_rng([self.seed, step])
        rate = self.qps * (self.burst_mult if self._bursting(step) else 1.0)
        n = int(rng.poisson(rate))
        t = step + np.sort(rng.random(n))
        dom = rng.choice(self.cfg.n_domains, size=n,
                         p=self._probs).astype(np.int32)
        qs = rng.integers(1, 1 << 31, size=n, dtype=np.int64).astype(np.uint32)
        return t, dom, qs

    def _materialize(self, through_step: int) -> None:
        while self._steps_done < through_step:
            t, dom, qs = self._step_arrivals(self._steps_done)
            self._time = np.concatenate([self._time, t])
            self._domain = np.concatenate([self._domain, dom])
            self._seed = np.concatenate([self._seed, qs])
            self._steps_done += 1

    # -- consumption --------------------------------------------------------

    def take(self, cursor: int, t_now: float) -> QueryBatch:
        """All arrivals with ``time <= t_now`` not yet consumed, starting at
        schedule position ``cursor`` (cursors are what checkpoints carry)."""
        self._materialize(int(np.ceil(t_now)) + 1)
        hi = int(np.searchsorted(self._time, t_now, side="right"))
        lo = min(cursor, hi)
        return QueryBatch(time=self._time[lo:hi].copy(),
                          domain=self._domain[lo:hi].copy(),
                          seed=self._seed[lo:hi].copy(), cursor=hi)

    def arrivals_until(self, t: float) -> int:
        """Total arrivals scheduled in [0, t] — for sizing/reporting."""
        self._materialize(int(np.ceil(t)) + 1)
        return int(np.searchsorted(self._time, t, side="right"))
