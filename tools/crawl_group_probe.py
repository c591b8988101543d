#!/usr/bin/env python3
"""Whether a crawl process pays for being a rank: the webparf.CONFIG
crawl at 4 shards on one card, the same session in this process and in
fresh processes started as the crawl group starts its ranks, in one run:

    python3 tools/crawl_group_probe.py

Modes, each a process of its own after this one's ("parent"): "plain"
(no process group), "group" (an NCCL group of one rank,
``launch.mesh.init_crawl_group``), "group_omp1" (the same with
``OMP_NUM_THREADS=1``, as ``torch.distributed.run`` sets it). Per mode and
path (opic_url 64 steps, backlink 32): one warm-up interval, then REPS
sessions, each run once (pages/s) and then 3 intervals stepped one by one
(fetch- and dispatch-step ms). One JSON line per mode and path; the card's
name and power limit before them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 3
PATHS = (("opic_url", 64), ("backlink", 32))
MODES = ("plain", "group", "group_omp1")


def measure(mode: str) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as C
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    if mode.startswith("group"):
        from repro_torch.launch.mesh import init_crawl_group
        init_crawl_group()
    for ordering, steps in PATHS:
        cfg = scaled(webparf.CONFIG, ordering=ordering)
        warm = CrawlSession(cfg, device=None, n_shards=4)
        warm.run(cfg.dispatch_interval)
        del warm
        C.free_card()
        pages, fetch, disp = [], [], []
        for _ in range(REPS):
            sess = CrawlSession(cfg, device=None, n_shards=4)
            torch.cuda.synchronize()
            pages.append(sess.run(steps).pages_per_sec)
            f_ms, d_ms = C.step_ms(sess, 3 * cfg.dispatch_interval)
            fetch.append(f_ms)
            disp.append(d_ms)
            del sess
            C.free_card()
        print(json.dumps({
            "mode": mode, "ordering": ordering, "steps": steps,
            "torch_threads": torch.get_num_threads(),
            "pages_per_s": pages, "fetch_step_ms": fetch,
            "dispatch_step_ms": disp}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        measure(sys.argv[2])
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    print(C.nvidia_smi(), flush=True)
    measure("parent")
    port = C.free_port()
    for mode in MODES:
        env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1",
               "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        if mode == "group_omp1":
            env["OMP_NUM_THREADS"] = "1"
        subprocess.run([sys.executable, __file__, "--child", mode], env=env,
                       check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
