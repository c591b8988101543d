"""CrawlSession — the entry point of the port. Counterpart of
``repro/api/session.py``.

    sess = CrawlSession(cfg, n_shards=4)  # state built on the card
    rep = sess.run(64)                    # N cycles -> typed CrawlReport
    sess.inject_failure(1); sess.heal()   # C4 controls
    sess.checkpoint(d); sess.restore(d)   # the JAX package's .npz format

``n_shards`` is the JAX session's mesh size: the shards are batched along
the state's leading axis on one device, and a step launches each kernel
once for all of them. Under a crawl group (``launch.mesh.init_crawl_group``:
W processes, one a card) every rank builds the session with the same
arguments and holds its own L = N / W shards; the exchange, the reports'
gathers and the checkpoint are the group's collectives, so every rank
makes the same calls in the same order and gets the same reports, in
global shard order. ``heal`` and the load-driven rebalance move rows
between shards, and so between ranks (``dist.CrawlGroup.move_rows``):
every rank plans from the same gathered loads, records the same
rebalance events, and ends with the one-card session's state bit for bit.

With telemetry on (``cfg.telemetry`` or ``REPRO_TELEMETRY=1``) every step
also takes a ledger row of every shard (``obs/ledger.py``): an eager step
copies its row to the host, a chunk stacks its rows on the device and
copies them once. Spans, counters and the fail, heal and rebalance
instants go to ``self.tracer``; ``telemetry_report`` and
``CrawlReport.telemetry`` give the ledger window. With
``cfg.rebalance_threshold > 0`` (telemetry required) each dispatch
boundary checks the windowed load imbalance and may migrate hot domains
live -> live (``maybe_rebalance``). With telemetry off the step has no
hook.

The JAX session fuses a dispatch interval into one jitted ``lax.scan``
(``run_chunk``); PyTorch runs eagerly, so here a chunk is a plain loop over
the interval and the ``auto``, ``eager`` and ``scan`` modes produce the same
trajectory bit for bit. The session runs on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.report import (CrawlReport, gather_report, harvest,
                                    stats_dict, stats_per_shard)
from repro_torch.configs.base import CrawlConfig
from repro_torch.core import classifier as CLS
from repro_torch.core import crawler as CR
from repro_torch.core.stages import (CrawlState, FetchReport,
                                     dispatch_exchange, init_state,
                                     join_state, local_state,
                                     state_from_numpy, state_to_numpy)
from repro_torch.device import Device, resolve_device
from repro_torch.dist import CrawlGroup

Events = Dict[int, Callable]   # step index -> state transform, applied
                               # BEFORE that step executes

_OBS_DIR = "obs"               # ledger checkpoints live beside the state


class CrawlSession:
    """Owns the device, the step function, the crawl state and the step
    counter of ``n_shards`` crawl processes (any count that divides the
    config's domains and slots, and the crawl group's size): under a
    group, of this rank's share of them."""

    def __init__(self, cfg: CrawlConfig, device: Optional[Device] = None, *,
                 n_shards: int = 1, score_fn: Optional[Callable] = None,
                 classify_accuracy: float = CLS.DEFAULT_ACCURACY,
                 stages: Optional[Sequence] = None,
                 extra_stages: Sequence = (),
                 dispatch_stage: Optional[Callable] = None, tracer=None):
        """``score_fn`` (stateless ``(urls, cfg)``) overrides the ordering
        registry's scorer (by default ``cfg.ordering`` decides).
        ``extra_stages`` slots scenario stages (``make_politeness_stage``,
        ``make_revisit_stage``, ...) into the pipeline by their
        ``placement``; ``stages`` replaces the whole pipeline as given;
        ``dispatch_stage`` replaces ``dispatch_exchange`` on dispatch
        steps. ``tracer`` shares an ``obs.Tracer`` across sessions."""
        from repro_torch import obs
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_shards = n_shards
        self.group = CrawlGroup.current()
        self.telemetry = obs.telemetry_enabled(cfg)
        self._rebalance = None
        if cfg.rebalance_threshold > 0:
            if not self.telemetry:
                raise ValueError(
                    "rebalance_threshold > 0 needs telemetry=True: the "
                    "trigger signal is the ledger's load-imbalance factor")
            from repro_torch.rebalance import get_rebalance
            self._rebalance = get_rebalance(cfg.rebalance)
        self._step_fn = CR.make_crawl_step(
            cfg, n_shards=self.n_shards, device=self.device,
            score_fn=score_fn, classify_accuracy=classify_accuracy,
            stages=stages, extra_stages=tuple(extra_stages),
            dispatch_stage=dispatch_stage or dispatch_exchange)
        self.state: CrawlState = init_state(cfg, self.n_shards, self.device)
        self._t = 0
        self.tracer = tracer if tracer is not None else obs.Tracer()
        self.ledger = (obs.LedgerBuffer(obs.ledger_metrics(cfg), n_shards)
                       if self.telemetry else None)
        self.rebalance_events: list = []

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
        self.rebalance_events = []
        if self.telemetry:
            self.ledger.clear()
        return self

    def step(self) -> FetchReport:
        """Advance ONE cycle; fetch vs dispatch follows the step counter.
        The report holds every shard's rows (gathered under a group)."""
        return gather_report(self._step())

    def _step(self) -> FetchReport:
        """``step`` with this rank's rows of the report."""
        dispatch = (self._t + 1) % self.cfg.dispatch_interval == 0
        if not self.telemetry:
            self.state, rep = self._step_fn(self.state, dispatch=dispatch)
            self._t += 1
            return rep
        name = "step_dispatch" if dispatch else "step_fetch"
        with self.tracer.span(name, "stage", t=self._t):
            self.state, rep = self._step_fn(self.state, dispatch=dispatch)
            # the copy waits for the step's work on the device
            row = self.group.gather(self._snapshot(dispatch)).cpu().numpy()
        self._t += 1
        self.ledger.append(self._t, row)
        if dispatch:
            self._emit_counters()
            self.maybe_rebalance()
        return rep

    def run_chunk(self) -> FetchReport:
        """Advance one dispatch interval and return its stacked FetchReport
        (leading time axis), every shard's rows. The step counter must sit
        on an interval boundary, so that the chunk's last step is the
        dispatch step. With telemetry on, the interval's ledger rows are
        stacked on the device and copied to the host once."""
        return gather_report(self.run_chunk_local())

    def run_chunk_local(self) -> FetchReport:
        """``run_chunk`` with this rank's rows of the report (every row in
        one process), as the serve path's index fold takes them."""
        iv = self.cfg.dispatch_interval
        if self._t % iv:
            raise ValueError(
                f"run_chunk: step counter t={self._t} is not aligned to "
                f"dispatch_interval={iv}; use .step() to reach a boundary")
        if not self.telemetry:
            reps = [self._step() for _ in range(iv)]
            return FetchReport(*(torch.stack(x) for x in zip(*reps)))
        reps, rows = [], []
        with self.tracer.span("run_chunk", "stage", t=self._t, interval=iv):
            for i in range(iv):
                dispatch = i == iv - 1
                self.state, rep = self._step_fn(self.state,
                                                dispatch=dispatch)
                reps.append(rep)
                rows.append(self._snapshot(dispatch))
            rows = self.group.gather(torch.stack(rows), dim=1).cpu().numpy()
        t0, self._t = self._t, self._t + iv
        self.ledger.append_block(range(t0 + 1, t0 + iv + 1), rows)
        self._emit_counters()
        self.maybe_rebalance()
        return FetchReport(*(torch.stack(x) for x in zip(*reps)))

    # -- telemetry ----------------------------------------------------------

    def _snapshot(self, dispatch: bool) -> torch.Tensor:
        """This rank's shards' ledger rows."""
        from repro_torch.obs.ledger import snapshot_local
        return snapshot_local(self.cfg, self.state, dispatch)

    def _emit_counters(self) -> None:
        """Counter events at each dispatch boundary: the ledger's tail as
        Chrome ``C`` rows, one series per shard."""
        tail = self.ledger.tail()
        for metric in ("frontier_depth", "staging_fill"):
            if metric in tail:
                self.tracer.counter(metric, {
                    f"shard{i}": v for i, v in enumerate(tail[metric])})

    def telemetry_report(self, *, start: int = 0):
        """The session's :class:`~repro_torch.obs.health.CrawlTelemetry`
        (the ledger from record ``start`` on, and every span so far); None
        with telemetry off."""
        if not self.telemetry:
            return None
        from repro_torch.obs.health import CrawlTelemetry
        steps, rows = self.ledger.arrays()
        return CrawlTelemetry(steps=steps[start:], rows=rows[start:],
                              names=self.ledger.names,
                              interval=self.cfg.dispatch_interval,
                              spans=tuple(self.tracer.events))

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
        led0 = len(self.ledger) if self.telemetry else 0
        reb0 = len(self.rebalance_events)
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
                           stats_per_shard=stats_per_shard(self.state),
                           telemetry=self.telemetry_report(start=led0),
                           rebalances=tuple(self.rebalance_events[reb0:]))

    def inject_failure(self, shards: Union[int, Sequence[int]]
                       ) -> "CrawlSession":
        """Mark crawl process(es) dead (wraps ``crawler.mark_dead``); under
        a crawl group every rank marks them in its copy of
        ``shard_alive``."""
        shards = [shards] if isinstance(shards, int) else list(shards)
        self.state = CR.mark_dead(self.state, shards)
        if self.telemetry:
            self.tracer.instant("inject_failure", "fault", t=self._t,
                                shards=list(shards))
        return self

    def heal(self, shards: Union[int, Sequence[int], None] = None
             ) -> "CrawlSession":
        """Rebalance dead shards' domains onto the survivors (wraps
        ``train.fault.heal_crawler``). Defaults to every shard dead in
        ``state.shard_alive``. Under a crawl group the rows cross ranks,
        and every rank must call it."""
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
        if self.telemetry:
            self.tracer.instant("heal", "fault", t=self._t,
                                shards=list(shards))
        return self

    # -- load-driven elastic repartitioning ----------------------------------

    def _windowed_imbalance(self) -> float:
        """The trigger signal: the mean load-imbalance factor over the last
        ``cfg.rebalance_window`` dispatch-boundary ledger records."""
        from repro_torch.obs.health import CrawlTelemetry
        steps, rows = self.ledger.arrays()
        tel = CrawlTelemetry(steps=steps, rows=rows, names=self.ledger.names,
                             interval=self.cfg.dispatch_interval)
        imb = tel.per_interval().imbalance()
        if not len(imb):
            return 1.0
        w = max(self.cfg.rebalance_window, 1)
        return float(imb[-w:].mean())

    def maybe_rebalance(self):
        """The host-side check at every dispatch boundary when
        ``cfg.rebalance_threshold > 0``: if the windowed load imbalance
        passes the threshold, the configured rebalance policy plans a
        live -> live migration from the rows' depth and cash (f64 on the
        host), and ``crawler.apply_rebalance`` applies it as a heal's is.
        Under a crawl group the depths (integers) and cash (f64 bits) of
        every rank's rows are gathered first, so every rank plans the same
        moves. Returns the recorded
        :class:`~repro_torch.rebalance.RebalanceEvent`, or None (disabled,
        under the threshold, or no move pays)."""
        if self._rebalance is None:
            return None
        trigger = self._windowed_imbalance()
        if trigger <= self.cfg.rebalance_threshold:
            return None
        from repro_torch.ordering.policies import ORD_URL0
        from repro_torch.rebalance import RebalanceEvent
        state = self.state
        row_depth = self.group.gather(state.f_valid.sum(dim=1)).cpu(
        ).numpy().astype(np.float64)
        os_ = state.order_state.cpu().numpy().astype(np.float64)
        row_cash = self.group.gather(torch.from_numpy(
            os_[:, 0] + os_[:, ORD_URL0:].sum(axis=1)).to(self.device)
        ).cpu().numpy()
        dm = CR.domain_map(state)
        decision = self._rebalance.plan(self.cfg, dm, row_depth, row_cash)
        if decision is None:
            return None
        with self.tracer.span("rebalance", "rebalance", t=self._t,
                              n_moves=len(decision.moves)):
            self.state = CR.apply_rebalance(state, self.cfg,
                                            decision.new_map)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        event = RebalanceEvent(step=self._t, trigger=trigger,
                               moves=decision.moves,
                               imbalance_before=decision.imbalance_before,
                               imbalance_after=decision.imbalance_after)
        self.rebalance_events.append(event)
        self.tracer.instant("rebalance", "rebalance", **event.asdict())
        return event

    def checkpoint(self, ckpt_dir: str, *, keep: int = 3) -> str:
        """Write the full crawl state atomically in the JAX package's
        checkpoint format; returns the path. Under a crawl group the state
        is gathered and rank 0 writes it: the same files a one-process
        session of ``n_shards`` writes. With telemetry on, the ledger is
        written beside it (an ``obs/`` directory), as the JAX session
        writes it."""
        from repro_torch.train import checkpoint as ckpt
        if not self.telemetry:
            return ckpt.save(ckpt_dir, self._t, self._whole_arrays(),
                             keep=keep)
        with self.tracer.span("checkpoint", "io", step=self._t):
            path = ckpt.save(ckpt_dir, self._t, self._whole_arrays(),
                             keep=keep)
            steps, rows = self.ledger.arrays()
            ckpt.save(os.path.join(ckpt_dir, _OBS_DIR), self._t,
                      {"steps": steps, "rows": rows}, keep=keep)
        return path

    def restore(self, ckpt_dir: str, *, step: Optional[int] = None
                ) -> "CrawlSession":
        """Restore a state (latest step by default, from either package)
        and resync the step counter. Its shard count must be the
        session's. With telemetry on, the ledger written beside it is
        restored too (a checkpoint without one starts a fresh ledger)."""
        from repro_torch.train import checkpoint as ckpt
        if not self.telemetry:
            self._restore_state(ckpt_dir, step)
            return self
        with self.tracer.span("restore", "io"):
            self._restore_state(ckpt_dir, step)
            obs_dir = os.path.join(ckpt_dir, _OBS_DIR)
            if self._t in ckpt.all_steps(obs_dir):
                led = ckpt.load(obs_dir, step=self._t)
                self.ledger.load(led["steps"], led["rows"])
            else:
                self.ledger.clear()
        return self

    def _whole_arrays(self):
        """Every leaf of the whole state as numpy on rank 0 (gathered
        under a group); None on the other ranks, which write nothing."""
        whole = join_state(self.state)
        return state_to_numpy(whole) if self.group.rank == 0 else None

    def _restore_state(self, ckpt_dir: str, step: Optional[int]) -> None:
        from repro_torch.train import checkpoint as ckpt
        arrays = ckpt.load(ckpt_dir, step=step)
        if arrays["stats"].shape[0] != self.n_shards:
            raise ValueError(f"restore: the checkpoint holds "
                             f"{arrays['stats'].shape[0]} shards, the "
                             f"session {self.n_shards}")
        # this rank's share, cut by state_specs: a checkpoint of N shards
        # restores at any world size
        self.state = state_from_numpy(local_state(arrays, self.n_shards),
                                      self.device)
        self._t = int(self.state.step)
