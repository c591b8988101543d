"""CrawlSession — the entry point of the port. Counterpart of
``repro/api/session.py``.

    sess = CrawlSession(cfg, n_shards=4)  # state built on the card
    rep = sess.run(64)                    # N cycles -> typed CrawlReport
    sess.inject_failure(1); sess.heal()   # C4 controls
    sess.checkpoint(d); sess.restore(d)   # the JAX package's .npz format

``n_shards`` is the JAX session's mesh size: the shards are batched along
the state's leading axis on one device, and a step launches each kernel
once for all of them.

The JAX session fuses a dispatch interval into one jitted ``lax.scan``
(``run_chunk``); PyTorch runs eagerly, so here a chunk is a plain loop over
the interval and the ``auto``, ``eager`` and ``scan`` modes produce the same
trajectory bit for bit. The session runs on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.report import (CrawlReport, harvest, stats_dict,
                                    stats_per_shard)
from repro_torch.configs.base import CrawlConfig
from repro_torch.core import classifier as CLS
from repro_torch.core import crawler as CR
from repro_torch.core.stages import (CrawlState, FetchReport, init_state,
                                     state_from_numpy, state_to_numpy)
from repro_torch.device import Device, resolve_device

Events = Dict[int, Callable]   # step index -> state transform, applied
                               # BEFORE that step executes


class CrawlSession:
    """Owns the device, the step function, the crawl state and the step
    counter of ``n_shards`` crawl processes (any count that divides the
    config's domains and slots)."""

    def __init__(self, cfg: CrawlConfig, device: Optional[Device] = None, *,
                 n_shards: int = 1,
                 classify_accuracy: float = CLS.DEFAULT_ACCURACY,
                 extra_stages: Sequence = ()):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_shards = n_shards
        self._step_fn = CR.make_crawl_step(
            cfg, n_shards=self.n_shards, device=self.device,
            classify_accuracy=classify_accuracy,
            extra_stages=tuple(extra_stages))
        self.state: CrawlState = init_state(cfg, self.n_shards, self.device)
        self._t = 0

    @property
    def t(self) -> int:
        """Steps taken so far."""
        return self._t

    @property
    def stats(self) -> Dict[str, int]:
        return stats_dict(self.state)

    def reset(self) -> "CrawlSession":
        """Fresh crawl state and step counter 0."""
        self.state = init_state(self.cfg, self.n_shards, self.device)
        self._t = 0
        return self

    def step(self) -> FetchReport:
        """Advance ONE cycle; fetch vs dispatch follows the step counter."""
        dispatch = (self._t + 1) % self.cfg.dispatch_interval == 0
        self.state, rep = self._step_fn(self.state, dispatch=dispatch)
        self._t += 1
        return rep

    def run_chunk(self) -> FetchReport:
        """Advance one dispatch interval and return its stacked FetchReport
        (leading time axis). The step counter must sit on an interval
        boundary, so that the chunk's last step is the dispatch step."""
        iv = self.cfg.dispatch_interval
        if self._t % iv:
            raise ValueError(
                f"run_chunk: step counter t={self._t} is not aligned to "
                f"dispatch_interval={iv}; use .step() to reach a boundary")
        reps = [self.step() for _ in range(iv)]
        return FetchReport(*(torch.stack(x) for x in zip(*reps)))

    def run(self, steps: int, *, events: Optional[Events] = None,
            collect: str = "urls", mode: str = "auto") -> CrawlReport:
        """Drive ``steps`` cycles and return a :class:`CrawlReport`.

        events  — {step index: fn(state) -> state}, applied before that
                  step (session-absolute indices).
        collect — "urls" (fetched URLs) or "counts" (per-step counts only).
        mode    — "auto" runs whole intervals as chunks where events and
                  alignment allow, "eager" steps one by one, "scan" demands
                  whole chunks (raises otherwise). All three give the same
                  trajectory."""
        if mode not in ("auto", "eager", "scan"):
            raise ValueError(f"unknown mode {mode!r}")
        if collect not in ("urls", "counts"):
            raise ValueError(f"unknown collect {collect!r}")
        iv = self.cfg.dispatch_interval
        events = events or {}
        t_end = self._t + steps
        if mode == "scan":
            bad = self._t % iv or steps % iv or \
                any(e % iv for e in events if self._t <= e < t_end)
            if bad:
                raise ValueError(
                    "mode='scan' needs an interval-aligned start, an "
                    "interval-multiple step count, and no mid-interval "
                    f"events (t={self._t}, steps={steps}, interval={iv})")

        url_parts, per_step = [], []
        t0 = time.time()
        while self._t < t_end:
            t = self._t
            if t in events:
                self.state = events[t](self.state)
            fits = (t % iv == 0) and (t + iv <= t_end)
            clear = not any(t < e < t + iv for e in events)
            rep = (self.run_chunk() if mode != "eager" and fits and clear
                   else self.step())
            u, c = harvest(rep)
            per_step.extend(c)
            if collect == "urls":
                url_parts.extend(u)
        seconds = time.time() - t0

        urls = (np.concatenate(url_parts) if url_parts
                else np.array([], np.uint32))
        return CrawlReport(urls=urls,
                           per_step=np.asarray(per_step, np.int64),
                           stats=stats_dict(self.state), seconds=seconds,
                           cfg=self.cfg,
                           stats_per_shard=stats_per_shard(self.state))

    def inject_failure(self, shards: Union[int, Sequence[int]]
                       ) -> "CrawlSession":
        """Mark crawl process(es) dead (wraps ``crawler.mark_dead``)."""
        shards = [shards] if isinstance(shards, int) else list(shards)
        self.state = CR.mark_dead(self.state, shards)
        return self

    def heal(self, shards: Union[int, Sequence[int], None] = None
             ) -> "CrawlSession":
        """Rebalance dead shards' domains onto the survivors (wraps
        ``train.fault.heal_crawler``). Defaults to every shard dead in
        ``state.shard_alive``."""
        from repro_torch.train.fault import heal_crawler
        if shards is None:
            shards = [int(s) for s in
                      np.flatnonzero(~self.state.shard_alive.cpu().numpy())]
        elif isinstance(shards, int):
            shards = [shards]
        else:
            shards = list(shards)
        if not shards:
            raise ValueError("heal: no dead shards in state and none given")
        self.state = heal_crawler(self.state, self.cfg, shards, self.n_shards)
        return self

    def checkpoint(self, ckpt_dir: str, *, keep: int = 3) -> str:
        """Write the full crawl state atomically in the JAX package's
        checkpoint format; returns the path."""
        from repro_torch.train import checkpoint as ckpt
        return ckpt.save(ckpt_dir, self._t, state_to_numpy(self.state),
                         keep=keep)

    def restore(self, ckpt_dir: str, *, step: Optional[int] = None
                ) -> "CrawlSession":
        """Restore a state (latest step by default, from either package)
        and resync the step counter. Its shard count must be the
        session's."""
        from repro_torch.train import checkpoint as ckpt
        arrays = ckpt.load(ckpt_dir, step=step)
        if arrays["stats"].shape[0] != self.n_shards:
            raise ValueError(f"restore: the checkpoint holds "
                             f"{arrays['stats'].shape[0]} shards, the "
                             f"session {self.n_shards}")
        self.state = state_from_numpy(arrays, self.device)
        self._t = int(self.state.step)
        return self
