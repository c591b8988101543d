#!/usr/bin/env python3
"""Launches, device events and host syncs a step of the exchange crawl at
webparf.CONFIG with 4 shards, for the port tree under ``--src`` (this
checkout's ``src`` by default, or a parent commit's, unpacked with ``git
archive``), so that two trees can be held against each other in one run
on one card:

    python3 tools/step_counts.py --src build/parent/src --src src

Each tree runs in a process of its own, in the order given. Per tree and
path (opic_url, backlink): 32 steps with the launch counts zeroed just
before and read just after, then a profile over 2 dispatch intervals
(``chip_smoke.profile_device``) and the host syncs over 2 more
(``chip_smoke.count_syncs``). One JSON line per tree and path; the last
line says whether the trees' launches and syncs were equal.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 32


def measure(src: str) -> None:
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as C
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    from repro_torch.kernels import launch_counts, reset_launches
    import repro_torch
    for ordering in ("opic_url", "backlink"):
        sess = CrawlSession(scaled(webparf.CONFIG, ordering=ordering),
                            device="cuda", n_shards=4)
        torch.cuda.synchronize()
        reset_launches()
        rep = sess.run(STEPS)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        iv = sess.cfg.dispatch_interval
        prof = C.profile_device(lambda: [sess.step() for _ in range(2 * iv)],
                                2 * iv)
        n_sync, lines = C.count_syncs(sess, 2 * iv)
        print(json.dumps({
            "src": src, "package": str(Path(repro_torch.__file__).parent),
            "ordering": ordering, "steps": STEPS, "launches": counts,
            "pages_per_s": rep.pages_per_sec,
            "device_events_per_step": prof["device_events_per_call"],
            "device_busy_ms_per_step": prof["device_busy_ms_per_call"],
            "device_idle_share": prof["device_idle_share"],
            "host_syncs_per_step": n_sync / (2 * iv),
            "sync_lines": lines}), flush=True)
        del sess
        C.free_card()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=None)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        measure(args.one)
        return 0
    lines = []
    for src in args.src or ["src"]:
        out = subprocess.run([sys.executable, __file__, "--one", src],
                             capture_output=True, text=True, check=True)
        got = [json.loads(x) for x in out.stdout.splitlines()
               if x.startswith("{")]
        for g in got:
            print(json.dumps(g), flush=True)
        lines.append(got)
    keys = ("launches", "host_syncs_per_step")
    same = all([{k: g[k] for k in keys} for g in got] ==
               [{k: g[k] for k in keys} for g in lines[0]] for got in lines)
    print(json.dumps({"trees": args.src, "launches_and_syncs_equal": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
