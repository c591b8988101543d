"""ServeSession — live crawl -> index -> serve on one device. Counterpart
of ``repro/serve/session.py``.

The paper's Figure 1 casts the partitioned crawl as the feeder of an
index -> search cascade. ``ServeSession`` runs that loop as one pipeline,
built on :class:`repro_torch.api.CrawlSession`:

  per dispatch interval:
    1. ``CrawlSession.run_chunk()`` advances the crawl one interval;
    2. the queries that ARRIVED during that window (an open-loop schedule,
       ``serve/load.py``) are answered from the index as of the previous
       fold, in batches of ``query_batch`` (``serve/query.py``);
    3. the interval's fetched pages fold into the sharded index on the
       device (the FetchReport's tensors, no host round trip).

Under a crawl group (``launch.mesh.init_crawl_group``) every rank runs the
loop with the same arguments: it crawls and indexes its own shards, draws
the same query load from the seed, and answers through the query path's
collectives, so every rank serves the same URLs and scores; rank 0
computes recall against the oracle and gives it to the others.

Serve-then-fold is the honest order: a query arriving mid-interval cannot
see that interval's pages, so the freshness lag is at least one interval,
and ``index_every`` widens the fold period and the lag with it.

Latency is stamped with the host clock after ``torch.cuda.synchronize()``
on the card (the JAX session's ``block_until_ready``), so that a query
batch's latency includes its device work. ``run`` returns a typed
:class:`~repro_torch.serve.report.ServeReport`. ``checkpoint``/``restore``
write the index leaves and the serve cursors under ``serve/`` beside the
crawl state, in the JAX package's format: either package restores what the
other wrote, and a restored session serves the same answers.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.report import (CrawlReport, gather_report, harvest,
                                    stats_dict, stats_per_shard)
from repro_torch.api.session import CrawlSession
from repro_torch.configs.base import CrawlConfig
from repro_torch.core import index as IX
from repro_torch.device import Device
from repro_torch.serve import query as Q
from repro_torch.serve.load import QueryBatch, QueryLoad
from repro_torch.serve.report import ServeReport

_SERVE_DIR = "serve"        # index + cursors live next to the crawl ckpt


class ServeSession:
    """Owns a CrawlSession, the sharded live index, and the query loop."""

    def __init__(self, cfg: CrawlConfig, device: Optional[Device] = None, *,
                 n_shards: int = 1, load: Optional[QueryLoad] = None,
                 qps: float = 4.0, load_seed: int = 0,
                 index_capacity: int = 4096, doc_len: int = 64,
                 vocab: int = 4096, top_k: int = 10, n_query_terms: int = 8,
                 query_batch: int = 16, index_every: int = 1, **crawl_kw):
        """``load`` overrides the default generator (``qps``/``load_seed``
        then unused). ``index_capacity`` is GLOBAL (split evenly over the
        shards). ``index_every`` folds pages into the index every N
        intervals (the freshness lag scales with it). Other keywords go to
        :class:`CrawlSession` (``score_fn``, ``extra_stages``, ...)."""
        self.crawl = CrawlSession(cfg, device, n_shards=n_shards, **crawl_kw)
        self.cfg = cfg
        self.device = self.crawl.device
        self.n_shards = self.crawl.n_shards
        # one timeline: serve spans land on the crawl session's tracer
        self.telemetry = self.crawl.telemetry
        self.tracer = self.crawl.tracer
        if index_capacity % self.n_shards:
            raise ValueError(f"index_capacity={index_capacity} must divide "
                             f"over {self.n_shards} shards")
        self.cap_shard = index_capacity // self.n_shards
        if self.cap_shard < top_k:
            raise ValueError(f"per-shard capacity {self.cap_shard} < "
                             f"top_k {top_k}")
        self.group = self.crawl.group
        n_local, _ = self.group.split(self.n_shards)
        self.doc_len, self.vocab = int(doc_len), int(vocab)
        self.top_k, self.n_query_terms = int(top_k), int(n_query_terms)
        self.query_batch = int(query_batch)
        self.index_every = max(int(index_every), 1)
        self.load = load if load is not None else QueryLoad(
            cfg, qps=qps, seed=load_seed)
        self.index = Q.init_sharded_index(n_local, self.cap_shard,
                                          self.doc_len, self.vocab,
                                          self.device)
        self._add_fn = Q.make_index_add(cfg)
        self._query_fn = Q.make_query_fn(cfg, n_terms=self.n_query_terms,
                                         k=self.top_k)
        self._watermark = 0        # newest crawl step folded into the index
        self._q_cursor = 0         # load-schedule position consumed
        self._pending: List = []   # device reports awaiting a fold
        self._all_urls: List[np.ndarray] = []   # full page stream (oracle)

    # -- introspection ------------------------------------------------------

    @property
    def t(self) -> int:
        return self.crawl.t

    @property
    def watermark(self) -> int:
        """Crawl step of the newest indexed page (freshness anchor)."""
        return self._watermark

    @property
    def stats(self) -> Dict[str, int]:
        return self.crawl.stats

    def index_stats(self) -> Dict[str, int]:
        """Host-side index counters (one copy of two small leaves), every
        shard's."""
        return dict(
            index_docs=int(self.group.sum_int(self.index.n_docs.sum())),
            index_dropped=int(self.group.sum_int(
                self.index.n_dropped.sum())),
            index_capacity=self.cap_shard * self.n_shards,
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the serve loop -----------------------------------------------------

    def run(self, steps: int, *, recall: bool = True,
            collect: str = "urls") -> ServeReport:
        """Drive ``steps`` crawl cycles with interleaved serving.

        ``steps`` must be a multiple of ``dispatch_interval`` (the crawl
        advances in chunks). ``recall=False`` skips the full-index oracle
        pass."""
        iv = self.cfg.dispatch_interval
        if steps % iv or self.crawl.t % iv:
            raise ValueError(
                f"run: steps={steps} and t={self.crawl.t} must be multiples "
                f"of dispatch_interval={iv} (chunked execution)")
        lat, arr, lags = [], [], []
        top_u, top_s = [], []
        q_dom, q_seed = [], []
        url_parts: List[np.ndarray] = []
        per_step: List[int] = []
        crawl_secs = serve_secs = 0.0
        led0 = len(self.crawl.ledger) if self.telemetry else 0
        run_w0 = time.perf_counter()

        for _ in range(steps // iv):
            t_start = self.crawl.t
            w0 = time.perf_counter()
            reps = self.crawl.run_chunk_local()     # this rank's rows
            self._sync()
            w1 = time.perf_counter()
            crawl_secs += w1 - w0
            t_now = self.crawl.t

            # 2. answer the interval's arrivals from the live (lagging) index
            qb = self.load.take(self._q_cursor, float(t_now))
            self._q_cursor = qb.cursor
            if len(qb):
                serve_secs += self._serve(qb, t_start, t_now, w0, w1,
                                          lat, arr, lags, top_u, top_s)
                q_dom.append(qb.domain)
                q_seed.append(qb.seed)

            # 3. stream the chunk's pages into the index (incremental fold)
            self._pending.append(reps)
            if len(self._pending) >= self.index_every:
                self._flush_pending()
            u, c = harvest(gather_report(reps))
            per_step.extend(c)
            self._all_urls.extend(u)
            if collect == "urls":
                url_parts.extend(u)

        seconds = time.perf_counter() - run_w0
        crawl_tel = self.crawl.telemetry_report(start=led0)
        crawl_rep = CrawlReport(
            urls=(np.concatenate(url_parts) if url_parts
                  else np.array([], np.uint32)),
            per_step=np.asarray(per_step, np.int64),
            stats=stats_dict(self.crawl.state), seconds=crawl_secs,
            cfg=self.cfg,
            stats_per_shard=stats_per_shard(self.crawl.state),
            telemetry=crawl_tel)
        top_u_a = (np.concatenate(top_u) if top_u
                   else np.zeros((0, self.top_k), np.uint32))
        top_s_a = (np.concatenate(top_s) if top_s
                   else np.zeros((0, self.top_k), np.float32))
        rec = None
        if recall and len(top_u_a) and self._all_urls:
            rec = self._oracle_recall(
                np.concatenate(q_seed), np.concatenate(q_dom), top_u_a)
        lat_a = np.asarray(lat, np.float64)
        lags_a = np.asarray(lags, np.int64)
        serve_tel = None
        if crawl_tel is not None:
            from repro_torch.obs.health import ServeTelemetry
            serve_tel = ServeTelemetry(crawl=crawl_tel, lag_steps=lags_a,
                                       latency_ms=lat_a)
        return ServeReport(
            crawl=crawl_rep, latency_ms=lat_a,
            arrival_step=np.asarray(arr, np.float64),
            lag_steps=lags_a,
            top_urls=top_u_a, top_scores=top_s_a, k=self.top_k,
            seconds=seconds, serve_seconds=serve_secs,
            index=self.index_stats(), recall_at_k=rec, cfg=self.cfg,
            telemetry=serve_tel)

    def _batch(self, seeds: np.ndarray, doms: np.ndarray, lo: int):
        """Queries [lo, lo + query_batch) zero-padded to one batch on the
        device, and how many are real."""
        B = self.query_batch
        n = min(B, len(seeds) - lo)
        sd = np.zeros((B,), np.int64)
        dm = np.zeros((B,), np.int64)
        sd[:n] = seeds[lo:lo + n]
        dm[:n] = doms[lo:lo + n]
        return (torch.from_numpy(sd).to(self.device),
                torch.from_numpy(dm).to(self.device), n)

    def _serve(self, qb: QueryBatch, t_start: int, t_now: int,
               w0: float, w1: float, lat, arr, lags, top_u, top_s) -> float:
        """Run one interval's arrivals through the batched query path."""
        lag = t_now - self._watermark
        # map step-time arrivals into the interval's wall window: queries
        # arrived WHILE the chunk crawled, so they queue behind it
        frac = (qb.time - t_start) / max(t_now - t_start, 1)
        arrival_wall = w0 + np.clip(frac, 0.0, 1.0) * (w1 - w0)
        spent = 0.0
        for lo in range(0, len(qb), self.query_batch):
            b0 = time.perf_counter()
            seeds, doms, n = self._batch(qb.seed, qb.domain, lo)
            if self.telemetry:
                with self.tracer.span("query_batch", "serve", n=n,
                                      lag_steps=lag):
                    s, u = self._query_fn(self.index, seeds, doms)
                    self._sync()
            else:
                s, u = self._query_fn(self.index, seeds, doms)
                self._sync()
            done = time.perf_counter()
            spent += done - b0
            lat.extend((done - arrival_wall[lo:lo + n]) * 1e3)
            arr.extend(qb.time[lo:lo + n])
            lags.extend([lag] * n)
            top_u.append(u[:n].cpu().numpy().astype(np.uint32))
            top_s.append(s[:n].cpu().numpy())
        return spent

    def _flush_pending(self) -> None:
        if self.telemetry and self._pending:
            with self.tracer.span("index_fold", "serve",
                                  n_intervals=len(self._pending)):
                for rep in self._pending:
                    self.index = self._add_fn(self.index, rep)
                self._sync()
        else:
            for rep in self._pending:
                self.index = self._add_fn(self.index, rep)
        self._pending = []
        self._watermark = self.crawl.t

    def _oracle_recall(self, seeds: np.ndarray, doms: np.ndarray,
                       served: np.ndarray) -> float:
        """recall@k against the full-index oracle: rank 0 computes it
        (every rank holds the same page stream and answers) and gives it
        to the others."""
        rec = None
        if self.group.rank == 0:
            rec = self._oracle_recall_here(seeds, doms, served)
        return self.group.broadcast(rec)

    def _oracle_recall_here(self, seeds: np.ndarray, doms: np.ndarray,
                            served: np.ndarray) -> float:
        pages = np.concatenate(self._all_urls)
        oracle = Q.oracle_index(pages, self.cfg, doc_len=self.doc_len,
                                vocab=self.vocab, device=self.device)
        want = Q.oracle_search(oracle, seeds, doms,
                               n_terms=self.n_query_terms, k=self.top_k,
                               cfg=self.cfg)
        return Q.recall_at_k(served, want)

    # -- one-off queries (examples / smoke checks) --------------------------

    def answer(self, domains, seeds=None):
        """Answer ad-hoc queries against the live index: ``(scores, urls)``
        as (n, k) numpy. ``seeds`` defaults to the domain ids + 1."""
        domains = np.atleast_1d(np.asarray(domains, np.int32))
        seeds = (domains.astype(np.uint32) + 1 if seeds is None
                 else np.atleast_1d(np.asarray(seeds, np.uint32)))
        out_s, out_u = [], []
        for lo in range(0, len(domains), self.query_batch):
            sd, dm, n = self._batch(seeds, domains, lo)
            s, u = self._query_fn(self.index, sd, dm)
            out_s.append(s[:n].cpu().numpy())
            out_u.append(u[:n].cpu().numpy().astype(np.uint32))
        return np.concatenate(out_s), np.concatenate(out_u)

    # -- C4 fault controls (serving survives crawl-shard death) -------------

    def inject_failure(self, shards) -> "ServeSession":
        self.crawl.inject_failure(shards)
        return self

    def heal(self, shards=None) -> "ServeSession":
        """The crawl's heal (``CrawlSession.heal``: under a crawl group
        the rows cross ranks); the index blocks stay where they are."""
        self.crawl.heal(shards)
        return self

    # -- persistence --------------------------------------------------------

    def _serve_arrays(self) -> Dict[str, np.ndarray]:
        """The JAX package's serve checkpoint leaves: ``index/<field>``,
        ``watermark`` and ``q_cursor``, in its dtypes; every shard's
        blocks (gathered under a group: ``index_specs``)."""
        out = {f"index/{k}": self.group.gather(v).cpu().numpy()
               for k, v in zip(IX.Index._fields, self.index)}
        out["index/doc_url"] = out["index/doc_url"].astype(np.uint32)
        out["watermark"] = np.asarray(self._watermark, np.int32)
        out["q_cursor"] = np.asarray(self._q_cursor, np.int32)
        return out

    def checkpoint(self, ckpt_dir: str, *, keep: int = 3) -> str:
        """Write crawl state + index leaves + serve cursors atomically.
        Pending (unfolded) intervals are folded first so the on-disk index
        matches the watermark."""
        from repro_torch.train import checkpoint as ckpt
        self._flush_pending()
        path = self.crawl.checkpoint(ckpt_dir, keep=keep)
        # every rank gathers, rank 0 writes
        ckpt.save(os.path.join(ckpt_dir, _SERVE_DIR), self.crawl.t,
                  self._serve_arrays(), keep=keep)
        return path

    def restore(self, ckpt_dir: str, *, step: Optional[int] = None
                ) -> "ServeSession":
        """Restore crawl + index + schedule cursor (from either package);
        serving resumes exactly where the checkpoint left off."""
        from repro_torch.train import checkpoint as ckpt
        self.crawl.restore(ckpt_dir, step=step)
        arrays = ckpt.load(os.path.join(ckpt_dir, _SERVE_DIR),
                           step=self.crawl.t)
        leaves = []
        for k, like in zip(IX.Index._fields, self.index):
            # this rank's blocks of every shard's (index_specs)
            a = self.group.local(arrays[f"index/{k}"], self.n_shards)
            if a.shape != tuple(like.shape):
                raise ValueError(f"restore: index/{k} has shape {a.shape}, "
                                 f"the session {tuple(like.shape)}")
            leaves.append(torch.from_numpy(a.astype(
                np.int64 if k == "doc_url" else a.dtype)).to(self.device))
        self.index = IX.Index(*leaves)
        self._watermark = int(arrays["watermark"])
        self._q_cursor = int(arrays["q_cursor"])
        self._pending = []
        self._all_urls = []        # oracle stream restarts at the restore
        return self
