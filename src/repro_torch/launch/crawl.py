"""Standalone crawl-simulation driver — the paper's system end to end,
driven through the one session API (repro_torch.api.CrawlSession).
Counterpart of ``repro/launch/crawl.py``.

  PYTHONPATH=src python -m repro_torch.launch.crawl --steps 64 \
      --domains 32 --shards 4 --fail-shard 1 --fail-at 24 --heal-at 40
  PYTHONPATH=src python -m repro_torch.launch.crawl --device cpu

  python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.crawl --shards 4

Prints per-phase throughput and the C1/C2 overlap measurements. The JAX
driver's mesh size is ``--shards`` here: the crawl processes batched on
one device. Under ``torch.distributed.run`` (W processes, one a card:
``launch.mesh.init_crawl_group``) ``--shards`` is still the global count
N, each rank crawls N / W of them on its own card, the dispatch exchanges
through NCCL, and only rank 0 prints; ``--fail-shard/--fail-at/--heal-at``
and ``--rebalance-threshold`` move rows between the cards:

  python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.crawl --shards 4 --fail-shard 1 --fail-at 24 \
      --heal-at 40

It runs on cuda unless ``--device cpu`` is given (gloo under a group),
and raises when no card is present. ``--mode`` picks how the session
steps (``auto`` runs whole dispatch intervals as chunks, ``eager`` one
step at a time); the modes give the same trajectory. The kernels dispatch by device, so
``--kernel-impl`` takes ``auto`` only.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    import os

    from repro_torch.core import partitioner as PT

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--domains", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--fetch-batch", type=int, default=32)
    ap.add_argument("--dispatch-interval", type=int, default=4)
    ap.add_argument("--shards", type=int, default=1,
                    help="crawl processes, batched on one device, or split "
                         "over the ranks of torch.distributed.run (any "
                         "count that divides --domains and the world)")
    ap.add_argument("--device", default="cuda")
    from repro_torch.ordering import orderings
    ap.add_argument("--partitioning", default="webparf",
                    choices=list(PT.policies()))
    ap.add_argument("--ordering", default="backlink",
                    choices=list(orderings()),
                    help="URL-ordering policy per partitioned queue "
                         "(repro_torch.ordering registry; opic = stateful "
                         "importance estimation, opic_url = per-URL cash "
                         "over the frontier columns)")
    from repro_torch.coordination import coordinations
    ap.add_argument("--coordination", default="exchange",
                    choices=list(coordinations()),
                    help="inter-process coordination mode at dispatch time "
                         "(repro_torch.coordination registry; "
                         "firewall/crossover = zero communication, "
                         "batched = --comm-quota URLs per dispatch with "
                         "outbox carry)")
    ap.add_argument("--comm-quota", type=int, default=-1, metavar="Q",
                    help="batched mode: max URLs shipped per shard per "
                         "dispatch (-1 = unbounded)")
    ap.add_argument("--politeness", type=int, default=-1, metavar="N",
                    help="cap fetches per domain queue per step at N "
                         "(stages.make_politeness_stage)")
    ap.add_argument("--revisit", type=int, default=-1, metavar="N",
                    help="re-enqueue fetched URLs with an N-step-age "
                         "freshness score (stages.make_revisit_stage)")
    ap.add_argument("--kernel-impl", default="auto", choices=["auto"],
                    help="kernel dispatch: the hand-written kernel for a "
                         "CUDA tensor, its plain version for a CPU one")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "eager", "scan"],
                    help="driver execution path "
                         "(repro_torch.api.CrawlSession)")
    ap.add_argument("--classify-accuracy", type=float, default=0.9)
    ap.add_argument("--fail-shard", type=int, default=-1)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--heal-at", type=int, default=-1)
    ap.add_argument("--rebalance-threshold", type=float, default=0.0,
                    metavar="X",
                    help="arm load-driven elastic repartitioning (DESIGN.md "
                         "§18): when the windowed load-imbalance factor "
                         "(max/mean frontier depth over live shards) exceeds "
                         "X at a dispatch boundary, migrate the hottest "
                         "domains off the peak shard live->live; <=0 "
                         "disables; implies --trace (the ledger is the "
                         "trigger signal)")
    ap.add_argument("--trace", action="store_true",
                    help="enable telemetry (repro_torch.obs): per-shard "
                         "load "
                         "ledger + span tracing; prints the per-interval "
                         "shard-load timeline at the end")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write the Chrome trace_event file (.json or "
                         ".jsonl) with the ledger embedded; implies --trace")
    args = ap.parse_args(argv)
    trace = args.trace or bool(args.trace_out) or \
        args.rebalance_threshold > 0
    from repro_torch.dist import CrawlGroup
    group = CrawlGroup.current()
    started = ("WORLD_SIZE" in os.environ and group.world == 1
               and int(os.environ["WORLD_SIZE"]) > 1)
    if started:
        # started by torch.distributed.run: one rank a card
        from repro_torch.launch.mesh import init_crawl_group
        group = init_crawl_group(None if args.device == "cuda"
                                 else args.device)
    try:
        return _crawl(args, trace, group)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _crawl(args, trace, group):
    import numpy as np
    from repro_torch.api import CrawlSession
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import scaled
    from repro_torch.core import partitioner as PT
    from repro_torch.device import resolve_device

    def say(*a, **k):               # rank 0 speaks for the group
        if group.rank == 0:
            print(*a, **k)

    cfg = scaled(get_arch("webparf")[0], n_domains=args.domains,
                 frontier_capacity=args.capacity, fetch_batch=args.fetch_batch,
                 dispatch_interval=args.dispatch_interval,
                 bloom_bits_log2=16, dispatch_capacity=1024,
                 url_space_log2=24, partitioning=args.partitioning,
                 ordering=args.ordering, kernel_impl=args.kernel_impl,
                 coordination=args.coordination, comm_quota=args.comm_quota,
                 telemetry=trace,
                 rebalance_threshold=args.rebalance_threshold)
    from repro_torch.core import stages as ST
    extra = []
    if args.politeness >= 0:
        extra.append(ST.make_politeness_stage(args.politeness))
    if args.revisit >= 0:
        extra.append(ST.make_revisit_stage(args.revisit))
    # under a group, None is the rank's own card
    dev = resolve_device(None if args.device == "cuda" and group.world > 1
                         else args.device)
    sess = CrawlSession(cfg, dev, n_shards=args.shards,
                        classify_accuracy=args.classify_accuracy,
                        extra_stages=extra)
    # the kernels' route: hand-written on the card, the plain (ref)
    # versions on the CPU
    from repro_torch.kernels import registry
    say(f"{args.partitioning}: {args.domains} domains over "
        f"{sess.n_shards} shards, ordering={args.ordering}, "
        f"coordination={args.coordination} (kernels: "
        f"{registry.resolve_impl('frontier_select', dev.type)})")

    # C4 controls fire between run segments, at their exact step (fail
    # before heal when both land on the same step, like the old loop)
    actions = {}
    if args.fail_shard >= 0 and args.fail_at >= 0:
        actions.setdefault(args.fail_at, []).append("fail")
        if args.heal_at >= 0:
            actions.setdefault(args.heal_at, []).append("heal")

    # progress segments of ~16 steps, aligned to the dispatch interval so
    # --mode scan stays legal for any interval
    iv = cfg.dispatch_interval
    stride = max(iv, 16 - 16 % iv)
    reports = []
    while sess.t < args.steps:
        for act in actions.get(sess.t, ()):
            if act == "fail":
                sess.inject_failure(args.fail_shard)
                say(f"-- step {sess.t}: shard {args.fail_shard} died")
            else:
                sess.heal()
                say(f"-- step {sess.t}: rebalanced dead shard's domains")
        nxt = min([t for t in actions if t > sess.t]
                  + [args.steps, sess.t + stride])
        reports.append(sess.run(nxt - sess.t, mode=args.mode))
        frontier = int(group.sum_int(sess.state.f_valid.sum()))
        say(f"step {sess.t:4d}: "
            f"frontier={frontier}"
            f" fetched_total={sum(r.fetched for r in reports)}")

    urls = np.concatenate([r.urls for r in reports])
    dt = sum(r.seconds for r in reports)
    from repro_torch.api import overlap_metrics
    ov = overlap_metrics(urls, cfg)
    sd = sess.stats
    say(f"\n{len(urls)} pages in {dt:.1f}s "
        f"({len(urls)/max(dt, 1e-9):.0f} pages/s simulated)")
    say(f"C1 URL overlap:     "
        f"{len(urls) - len(np.unique(urls))} duplicate fetches"
        f" ({100 * ov['url_dup']:.2f}%)")
    say(f"C2 content overlap: "
        f"{round(ov['fetched'] * ov['content_dup'])} duplicate contents"
        f" ({100 * ov['content_dup']:.2f}%)")
    say(f"C5 exchange: {sd['dispatch_rounds']} rounds, "
        f"{sd['dispatch_sent']} URLs sent")
    from repro_torch.coordination import comm_ledger, ledger_line
    say(f"coordination[{args.coordination}]: "
        f"{ledger_line(comm_ledger(sd, len(urls)))}")
    from repro_torch.ordering import ordering_quality
    per_step = np.concatenate([r.per_step for r in reports])
    oq = ordering_quality(urls, per_step, cfg)
    say(f"ordering[{args.ordering}]: importance mass "
        f"{oq['importance_mass']:.1f} over {oq['unique_pages']} unique "
        f"pages ({oq['hot_pages']} hubs), coverage AUC "
        f"{oq['coverage_auc']:.3f}")
    say("stats:", sd)
    if sess.rebalance_events:
        say(f"elastic rebalance: {len(sess.rebalance_events)} migrations")
        for ev in sess.rebalance_events:
            say(f"  step {ev.step:4d}: domains {list(ev.domains)} moved "
                f"(trigger {ev.trigger:.2f}, imbalance "
                f"{ev.imbalance_before:.2f} -> {ev.imbalance_after:.2f})")

    if trace:
        from repro_torch.launch.trace_report import render_report
        tel = sess.telemetry_report()
        say(f"\n{render_report(tel)}")
        if args.trace_out and group.rank == 0:
            path = sess.tracer.write(args.trace_out, tel)
            say(f"\ntrace written: {path} "
                f"({len(sess.tracer.events)} events; load in "
                f"chrome://tracing or repro_torch.launch.trace_report)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
