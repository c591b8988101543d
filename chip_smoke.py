#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (a phase that fails raises, and the script exits
non-zero):

  1. build   — nvcc builds every kernel of the main path from csrc/, one
               process per source, all started together.
  2. parity  — each kernel against its plain PyTorch version on the card,
               exact equality, at the main path's shapes and at small shapes
               with ties and duplicates.
  3. main    — CrawlSession(webparf.CONFIG).run(64) on the card: 256
               domains, 512 frontier rows of 4096, 512 Bloom rows of 2^24
               bytes. Both kernels must have launched during the run.
     profile — the device's busy time over two more intervals
               (torch.profiler), its idle share, and the host syncs per
               step (torch's sync debug mode, and the profiler's
               cudaStreamSynchronize calls).
  4. trajectory — the CLI-sized config runs 32 steps on the card and on the
               CPU (plain versions); every output and state leaf must match.
  5. kernels — each kernel's time (CUDA events) beside its plain version's,
               a library call's where one computes the same function, and
               its bound: the bytes it must move over 3.35 TB/s.

Then the card's name and power limit as nvidia-smi gives them, and last the
line {"ok": true, "device": {...}}. Without a CUDA device, or without the
rest of the repository beside it, the script fails before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over n calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


# ---------------------------------------------------------------------------
# inputs, made with numpy from a seed
# ---------------------------------------------------------------------------

def frontier_rows(rng, R, C, *, fill=0.6, ties=False):
    """Frontier-like rows: invalid cells hold NEG; valid priorities are
    distinct f32 integers, or drawn from 4 values when ``ties``."""
    from repro_torch.kernels.frontier_select.ref import NEG
    url = rng.integers(1, 1 << 30, (R, C)).astype(np.int64)
    valid = rng.random((R, C)) < fill
    if R > 1:
        valid[0] = False                    # an empty row
        valid[1] = True                     # a full row
    pri = (rng.integers(0, 4, (R, C)) if ties else
           rng.permutation(R * C).reshape(R, C)).astype(np.float32)
    pri = np.where(valid, pri, np.float32(NEG)).astype(np.float32)
    return url, pri, valid


def bloom_batch(rng, R, M, *, dup=0.3, fill=0.8):
    """URL batches with repeats inside and across 256-URL tiles."""
    urls = rng.integers(0, 1 << 30, (R, M)).astype(np.int64)
    src = rng.integers(0, M, (R, M))
    rep = rng.random((R, M)) < dup
    rows = np.arange(R)[:, None]
    urls = np.where(rep, urls[rows, src], urls)
    mask = rng.random((R, M)) < fill
    if R > 1:
        mask[R - 1] = False                 # a fully masked row
    return urls, mask


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import all_kernels, build_all
    t0 = time.time()
    secs = build_all(all_kernels())
    ptxas = {k.name: [ln.strip() for ln in k.build_log.splitlines()
                      if "registers" in ln or "spill" in ln]
             for k in all_kernels()}
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "per_kernel_s": secs, "ptxas": ptxas, "card": nvidia_smi()})


def _select_pair(url, pri, valid, k):
    """Kernel and plain version of frontier_select on the same inputs;
    returns the largest absolute difference over every output."""
    import torch
    from repro_torch.kernels.frontier_select.ops import select
    from repro_torch.kernels.frontier_select.ref import select_ref
    dev = "cuda"
    u = torch.tensor(url, device=dev)
    p1, v1 = torch.tensor(pri, device=dev), torch.tensor(valid, device=dev)
    p2, v2 = p1.clone(), v1.clone()
    got = select(u, p1, v1, k=k, return_idx=True)
    want = select_ref(u, p2, v2, k=k, return_idx=True)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("sel_url", "sel_pri", "sel_mask", "idx", "pri'",
                           "valid'"), (*got, p1, v1), (*want, p2, v2)):
        if not torch.equal(a, b):
            raise AssertionError(f"frontier_select {tuple(url.shape)} k={k}:"
                                 f" {name} differs from the plain version")
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def _bloom_pair(bits, urls, mask, k):
    import torch
    from repro_torch.kernels.bloom.ops import probe_insert
    from repro_torch.kernels.bloom.ref import bloom_ref
    dev = "cuda"
    b1 = torch.tensor(bits, device=dev)
    b2 = b1.clone()
    u = torch.tensor(urls, device=dev)
    m = torch.tensor(mask, device=dev)
    s1 = probe_insert(b1, u, m, k=k)
    s2 = bloom_ref(b2, u, m, k=k, url_tile=min(256, u.shape[1]))
    torch.cuda.synchronize()
    if not torch.equal(s1, s2):
        raise AssertionError(f"bloom {tuple(urls.shape)} k={k}: seen differs")
    if not torch.equal(b1, b2):
        raise AssertionError(f"bloom {tuple(urls.shape)} k={k}: bits differ")
    return max(float((s1.int() - s2.int()).abs().max()),
               float((b1.int() - b2.int()).abs().max())), int(s1.sum())


def phase_parity():
    rng = np.random.default_rng(SEED)
    out = {"phase": "parity", "tolerance": "exact (max_abs_err 0)"}
    # frontier_select: the main path's (512, 4096, k=1), then small shapes
    err = _select_pair(*frontier_rows(rng, 512, 4096), 1)
    cases = [(512, 4096, 1, False)]
    for R, C, k, ties in [(4, 64, 1, True), (4, 64, 4, True),
                          (2, 128, 8, True), (3, 37, 4, False),
                          (2, 128, 8, False), (1, 32, 1, True)]:
        err = max(err, _select_pair(*frontier_rows(rng, R, C, ties=ties), k))
        cases.append((R, C, k, ties))
    out["frontier_select"] = {"max_abs_err": err, "cases": cases}
    # bloom: the main path's (R, 4096) at b=24, k=4 on a 16-row slice of
    # the filter (pre-filled so seen is often true), then small shapes
    R, M, b, k = 16, 4096, 24, 4
    bits = np.zeros((R, 1 << b), np.uint8)
    from repro_torch.kernels.bloom.ref import bloom_ref
    import torch
    pre_u, pre_m = bloom_batch(rng, R, M)
    bt = torch.tensor(bits)
    bloom_ref(bt, torch.tensor(pre_u), torch.tensor(pre_m), k=k)
    urls, mask = bloom_batch(rng, R, M)
    urls[:, ::3] = pre_u[:, ::3]            # a third were inserted before
    err, n_seen = _bloom_pair(bt.numpy(), urls, mask, k)
    cases = [(R, M, b, k, n_seen)]
    for R, M, b, k, dup in [(1, 256, 10, 2, 0.5), (4, 256, 12, 4, 0.3),
                            (2, 512, 14, 3, 0.6), (8, 512, 11, 5, 0.3),
                            (3, 300, 10, 4, 0.5), (2, 100, 9, 4, 0.9)]:
        urls, mask = bloom_batch(rng, R, M, dup=dup)
        e, n_seen = _bloom_pair(np.zeros((R, 1 << b), np.uint8), urls, mask,
                                k)
        err = max(err, e)
        cases.append((R, M, b, k, n_seen))
    out["bloom"] = {"max_abs_err": err, "cases": cases}
    emit(out)
    return {"frontier_select": out["frontier_select"]["max_abs_err"],
            "bloom": out["bloom"]["max_abs_err"]}


def phase_main(steps):
    import torch
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.kernels import launch_counts, reset_launches
    cfg = webparf.CONFIG
    t0 = time.time()
    sess = CrawlSession(cfg)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rep = sess.run(steps)
    torch.cuda.synchronize()
    counts = launch_counts()
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{counts}")
    stats = rep.stats
    if rep.steps != steps or rep.fetched != stats["fetched"] or \
            (rep.per_step <= 0).any() or rep.fetched != len(rep.urls):
        raise AssertionError(f"main path output malformed: {stats}")
    # per-step times, eager, after the run (not part of the launch counts)
    fetch_ms, disp_ms = [], []
    iv = cfg.dispatch_interval
    for _ in range(3 * iv):
        d = (sess.t + 1) % iv == 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        sess.step()
        torch.cuda.synchronize()
        (disp_ms if d else fetch_ms).append(1e3 * (time.perf_counter() - t))
    emit({"phase": "main", "config": "webparf.CONFIG", "steps": steps,
          "init_s": init_s, "seconds": rep.seconds,
          "pages_per_s": rep.pages_per_sec, "fetched": rep.fetched,
          "fetch_step_ms": float(np.mean(fetch_ms)),
          "dispatch_step_ms": float(np.mean(disp_ms)),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "url_dup": rep.overlap["url_dup"],
          "content_dup": rep.overlap["content_dup"],
          "queued_urls": int(sess.state.f_valid.sum()), "launches": counts,
          "stats": stats})
    return sess, counts


def count_syncs(sess, steps):
    """Host syncs in ``steps`` steps: torch's sync debug mode warns on
    every synchronizing CUDA call (a device-to-host copy, a boolean-mask
    index, a tensor's truth value). Returns the count and the source lines
    that synced most."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                sess.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    where = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in syncs)
    return len(syncs), dict(where.most_common(16))


def phase_profile(sess, steps):
    """Where a step's time goes: torch.profiler's CUDA events over whole
    dispatch intervals give the device's busy time, and so its idle share
    of the wall time (the profiler's own overhead included); the host syncs
    are counted twice, by the profiler's runtime calls and by torch's sync
    debug mode over as many steps again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sess.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    per_name, n, runtime = {}, 0, Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + e.time_range.elapsed_us())
            n += 1
        elif e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaMemcpyAsync", "cudaLaunchKernel"):
            runtime[e.name] += 1
    busy_us = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    n_sync, sync_lines = count_syncs(sess, steps)
    emit({"phase": "profile", "steps": steps, "wall_ms": wall_us / 1e3,
          "device_events": n, "device_busy_ms": busy_us / 1e3,
          "device_idle_share": 1 - busy_us / wall_us if n else None,
          "top_device_ms": {k[:80]: v / 1e3 for k, v in top},
          "runtime_calls_per_step": {k: v / steps
                                     for k, v in runtime.items()},
          "sync_debug_syncs_per_step": n_sync / steps,
          "sync_debug_lines": sync_lines})


def phase_trajectory(steps=32):
    import torch
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    from repro_torch.core.stages import state_to_numpy
    # launch/crawl.py's CLI size: 32 domains x 512, Bloom rows of 2^16
    cfg = scaled(webparf.CONFIG, n_domains=32, frontier_capacity=512,
                 fetch_batch=32, bloom_bits_log2=16, dispatch_capacity=1024,
                 url_space_log2=24)
    reps, states = {}, {}
    for dev in ("cuda", "cpu"):
        sess = CrawlSession(cfg, device=dev)
        reps[dev] = sess.run(steps)
        states[dev] = state_to_numpy(sess.state)
    torch.cuda.synchronize()
    a, b = reps["cuda"], reps["cpu"]
    diffs = [n for n in ("urls", "per_step")
             if not np.array_equal(getattr(a, n), getattr(b, n))]
    diffs += ["stats"] if a.stats != b.stats else []
    diffs += [n for n in states["cuda"]
              if not np.array_equal(states["cuda"][n], states["cpu"][n])]
    if diffs:
        raise AssertionError(f"cuda and cpu trajectories differ in {diffs}")
    if a.stats["dedup_bloom"] < 1:
        raise AssertionError("the trajectory never exercised the Bloom dedup")
    emit({"phase": "trajectory", "config": dataclasses.asdict(cfg),
          "steps": steps, "identical": True, "fetched": a.fetched,
          "dedup_bloom": a.stats["dedup_bloom"]})


def capture_dispatch_masks(sess, n):
    """The live-lane masks of the next n dispatches, as dispatch_exchange
    hands its (rows, M) batches to the Bloom dedup: each row's live URLs
    packed at its front by router.pack_buckets."""
    from repro_torch.core import dedup as DD
    orig, got = DD.probe_insert, []

    def spy(b, urls, mask, **kw):
        got.append(mask.clone())
        return orig(b, urls, mask, **kw)
    DD.probe_insert = spy
    try:
        while len(got) < n:
            sess.step()
    finally:
        DD.probe_insert = orig
    return got


def phase_kernels(sess, counts, errs, steps):
    import torch
    from repro_torch.kernels.bloom.ops import probe_insert
    from repro_torch.kernels.bloom.ref import _bit_indices, bloom_ref
    from repro_torch.kernels.frontier_select.ops import select
    from repro_torch.kernels.frontier_select.ref import NEG, select_ref
    cfg = sess.cfg
    n = 50
    out = []
    # frontier_select on the session's own frontier: (512, 4096), k = 1
    st = sess.state
    R, C = st.f_url.shape
    k = 1
    url = st.f_url
    p_k, v_k = st.f_pri.clone(), st.f_valid.clone()
    p_r, v_r = st.f_pri.clone(), st.f_valid.clone()
    p_l, v_l = st.f_pri.clone(), st.f_valid.clone()
    # bytes: every cell's priority and valid flag read; per row k popped
    # url/pri/mask written; per popped cell its url read, pri/valid written
    popped = int(torch.clamp(v_k.sum(dim=1), max=k).sum())
    nbytes = R * C * (4 + 1) + R * k * (8 + 4 + 1) + popped * (8 + 4 + 1)
    ms = cuda_ms(lambda: select(url, p_k, v_k, k=k), n)
    plain = cuda_ms(lambda: select_ref(url, p_r, v_r, k=k), n)
    lib = cuda_ms(lambda: torch.topk(torch.where(v_l, p_l, NEG), k, dim=1), n)
    out.append({"name": "frontier_select", "route": "cuda",
                "source": "src/repro_torch/csrc/frontier_select.cu",
                "replaces": "src/repro/kernels/frontier_select/"
                            "frontier_select.py:85",
                "launches": counts["frontier_select"],
                "launches_per_step": counts["frontier_select"] / steps,
                "max_abs_err": errs["frontier_select"], "ms": ms,
                "plain_ms": plain,
                "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                "bound_by": "bytes", "library_ms": lib})
    del p_k, v_k, p_r, v_r, p_l, v_l
    # bloom on the session's 8 GiB filter, with batches laid out as the
    # next dispatches lay them out (their masks), holding fresh URLs
    kh, b = cfg.bloom_hashes, cfg.bloom_bits_log2
    masks = capture_dispatch_masks(sess, 4)
    R, M = masks[0].shape
    rng = np.random.default_rng(SEED + 1)

    def batches():
        out = []
        for i in range(n + 1):
            m = masks[i % len(masks)]
            u = torch.zeros(m.shape, dtype=torch.int64, device="cuda")
            u[m] = torch.tensor(rng.integers(0, 1 << cfg.url_space_log2,
                                             int(m.sum())), device="cuda")
            out.append((u, m))
        return out
    kern_b, plain_b = batches(), batches()
    # bytes: every lane's mask read and seen written; the live URLs in
    # 32-byte sectors (4 lanes each); k probe bytes per live URL; and the
    # bytes newly set, counted on the filter around the timed calls
    nbytes, n_live, pos = 0, 0, []
    for u, m in kern_b:
        live = torch.nonzero(m.view(-1))[:, 0]
        n_live += live.numel()
        nbytes += 2 * R * M + 32 * torch.unique(live // 4).numel() \
            + kh * live.numel()
        rows = torch.nonzero(m)[:, :1]
        pos.append((rows * (1 << b) + _bit_indices(u, kh, b)[m]).view(-1))
    flat = st.bloom_bits.view(-1)
    pos = torch.unique(torch.cat(pos))
    before = flat[pos]
    it = iter(kern_b)
    ms = cuda_ms(lambda: probe_insert(st.bloom_bits, *next(it), k=kh), n)
    n_new = int(((before == 0) & (flat[pos] == 1)).sum())
    nbytes = (nbytes + n_new) / len(kern_b)
    it = iter(plain_b)
    plain = cuda_ms(lambda: bloom_ref(st.bloom_bits, *next(it), k=kh), n)
    out.append({"name": "bloom", "route": "cuda",
                "source": "src/repro_torch/csrc/bloom.cu",
                "replaces": "src/repro/kernels/bloom/bloom.py:61",
                "launches": counts["bloom"],
                "launches_per_step": counts["bloom"] / steps,
                "max_abs_err": errs["bloom"],
                "ms": ms, "plain_ms": plain,
                "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                "bound_by": "bytes", "library_ms": None,
                "shape": [R, M], "live_urls": n_live / len(kern_b),
                "new_bytes": n_new / len(kern_b)})
    emit({"kernels": out})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    phase_build()
    errs = phase_parity()
    steps = 64
    sess, counts = phase_main(steps)
    phase_profile(sess, 2 * sess.cfg.dispatch_interval)
    phase_trajectory()
    phase_kernels(sess, counts, errs, steps)
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
