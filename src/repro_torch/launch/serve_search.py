"""Live search-engine driver — crawl, index, and SERVE in one pipeline.

The paper's Figure 1 cascade under synthetic query traffic: the partitioned
crawl advances in fused dispatch intervals, each interval's pages stream
into the sharded index, and a Zipfian/bursty open-loop query load is
answered from the live index while the crawl runs (repro_torch/serve).
Counterpart of ``repro/launch/serve_search.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve_search --steps 48 \
      --domains 32 --shards 4 --qps 8 --fail-shard 1 --fail-at 16 \
      --heal-at 32
  PYTHONPATH=src python -m repro_torch.launch.serve_search --device cpu

The JAX driver's mesh size is ``--shards`` here. It runs on cuda unless
``--device cpu`` is given, and raises when no card is present.

Prints the ServeReport (p50/p95/p99 latency, QPS, freshness lag, recall@k)
next to the crawl's own throughput/overlap numbers.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import scaled
    from repro_torch.device import resolve_device
    from repro_torch.serve import QueryLoad, ServeSession

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--domains", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--fetch-batch", type=int, default=32)
    ap.add_argument("--dispatch-interval", type=int, default=4)
    ap.add_argument("--shards", type=int, default=1,
                    help="crawl processes and index shards, batched on one "
                         "device")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ordering", default="backlink")
    ap.add_argument("--partitioning", default="webparf")
    ap.add_argument("--coordination", default="exchange")
    # serve knobs
    ap.add_argument("--qps", type=float, default=8.0,
                    help="open-loop query arrivals per crawl step")
    ap.add_argument("--load-seed", type=int, default=0)
    ap.add_argument("--burst-mult", type=float, default=6.0,
                    help="arrival-rate multiplier inside burst blocks")
    ap.add_argument("--index-capacity", type=int, default=4096,
                    help="global doc capacity (split over shards)")
    ap.add_argument("--index-every", type=int, default=1,
                    help="fold pages into the index every N intervals "
                         "(freshness lag scales with this)")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--query-batch", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--doc-len", type=int, default=64)
    ap.add_argument("--no-recall", action="store_true",
                    help="skip the full-index oracle pass")
    # C4 controls
    ap.add_argument("--fail-shard", type=int, default=-1)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--heal-at", type=int, default=-1)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint mid-run and restore-resume (demo of "
                         "the serve-state round-trip)")
    ap.add_argument("--trace", action="store_true",
                    help="enable telemetry (repro_torch.obs): crawl ledger + "
                         "serve spans on one timeline")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write the Chrome trace_event file (.json or "
                         ".jsonl); implies --trace")
    args = ap.parse_args(argv)
    trace = args.trace or bool(args.trace_out)

    cfg = scaled(get_arch("webparf")[0], n_domains=args.domains,
                 frontier_capacity=args.capacity,
                 fetch_batch=args.fetch_batch,
                 dispatch_interval=args.dispatch_interval,
                 bloom_bits_log2=16, dispatch_capacity=1024,
                 url_space_log2=24, partitioning=args.partitioning,
                 ordering=args.ordering, coordination=args.coordination,
                 telemetry=trace)
    load = QueryLoad(cfg, qps=args.qps, seed=args.load_seed,
                     burst_mult=args.burst_mult)
    sess = ServeSession(cfg, resolve_device(args.device),
                        n_shards=args.shards, load=load,
                        index_capacity=args.index_capacity,
                        doc_len=args.doc_len, vocab=args.vocab,
                        top_k=args.top_k, query_batch=args.query_batch,
                        index_every=args.index_every)
    print(f"live pipeline: {args.domains} domains over {sess.n_shards} "
          f"shard(s), {args.qps} queries/step "
          f"(~{load.arrivals_until(args.steps)} arrivals over "
          f"{args.steps} steps), index capacity {args.index_capacity}")

    # segment boundaries: C4 events and the optional mid-run checkpoint
    iv = cfg.dispatch_interval
    marks = sorted({t for t in (args.fail_at, args.heal_at) if t >= 0}
                   | ({args.steps // (2 * iv) * iv} if args.ckpt_dir
                      else set()))
    reports = []
    while sess.t < args.steps:
        if args.fail_at == sess.t and args.fail_shard >= 0:
            sess.inject_failure(args.fail_shard)
            print(f"-- step {sess.t}: shard {args.fail_shard} died "
                  f"(serving continues, stale but correct)")
        if args.heal_at == sess.t and args.fail_shard >= 0:
            sess.heal()
            print(f"-- step {sess.t}: rebalanced; crawl feeds the index "
                  f"again")
        if args.ckpt_dir and marks and sess.t == marks[0] and \
                sess.t not in (args.fail_at, args.heal_at):
            path = sess.checkpoint(args.ckpt_dir)
            sess.restore(args.ckpt_dir)
            print(f"-- step {sess.t}: checkpointed + restored ({path}); "
                  f"resumed at watermark {sess.watermark}, "
                  f"query cursor {sess._q_cursor}")
        nxt = min([t for t in marks if t > sess.t] + [args.steps])
        reports.append(sess.run(nxt - sess.t, recall=not args.no_recall))
        r = reports[-1]
        print(f"step {sess.t:4d}: {r.n_queries} queries, "
              f"p50 {r.p50_ms:.1f}ms, lag {r.freshness_lag:.1f} steps, "
              f"{r.crawl.fetched} pages")

    print("\n== ServeReport (final segment) ==")
    print(reports[-1].summary())
    total_q = sum(r.n_queries for r in reports)
    total_s = sum(r.seconds for r in reports)
    print(f"\nwhole run: {total_q} queries in {total_s:.1f}s "
          f"({total_q / max(total_s, 1e-9):.1f} qps) while crawling "
          f"{sum(r.crawl.fetched for r in reports)} pages")

    if trace:
        from repro_torch.launch.trace_report import render_report
        tel = sess.crawl.telemetry_report()
        print(f"\n{render_report(tel)}")
        if args.trace_out:
            path = sess.tracer.write(args.trace_out, tel)
            print(f"\ntrace written: {path} "
                  f"({len(sess.tracer.events)} events; load in "
                  f"chrome://tracing or repro_torch.launch.trace_report)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
