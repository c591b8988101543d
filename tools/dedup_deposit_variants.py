#!/usr/bin/env python3
"""Time dedup_deposit as it stands against other sources of it on one
NVIDIA card, in one run.

    python3 tools/dedup_deposit_variants.py [--also NAME=old.cu]

Builds ``src/repro_torch/csrc/dedup_deposit.cu`` as it stands
(``as_shipped``) and each ``--also`` source with the same C entries, such
as an earlier commit's (``git show <rev>:src/repro_torch/csrc/
dedup_deposit.cu > build/parent.cu``) or a copy with one design choice
changed (PERF.md section 6 gives the times of a warp a row and of a twin
list scanned in place of the hash).

Inputs, from a crawl at ``webparf.CONFIG`` with ``ordering="opic_url"``
(512 frontier rows of 4,096 cells, 512 Bloom rows of 2^24 bytes, 64
steps): the crawl's own next ``chip_smoke.DEDUP_CALLS`` calls, captured as
``stages.py`` makes them (a few seen URLs among 2,048 live), replayed by
``chip_smoke.DedupReplay`` with every filter byte and lane cell they touch
restored before each replay; the same calls' masks re-sending URLs still
queued, URLs of the batch before and fresh URLs, a third each
(``chip_smoke.packed_batches``), replayed the same way; the same masks
with fresh URLs (``chip_smoke.fresh_graph_ms``); and, drawn from a seed
with numpy, 512 rows x 4,096 lanes (every lane live, half of them
re-sent) against a 60%-valid queue of 4,096 cells (a chunked queue).
Every variant must equal the plain version (``ref.dedup_deposit_ref``)
with torch.equal on seen, refund, the lane and the filter bytes, on every
replayed call and on the drawn batch. Times, in microseconds a call: the
replayed calls in one CUDA graph, restored before each replay (``graph``)
and with the L2 flushed after the restore (``graph_cold``), beside the
bound their data needs (``DedupReplay.nbytes`` over 3.35 TB/s); the fresh
batches the same two ways; the drawn batch by CUDA events; best and median
of four, two in the listed order and two in reverse. Before that, each
variant takes the wrapper's place in the crawl for 8 steps (two
dispatches) under torch.profiler, in the listed order and in reverse,
and the device time of one launch there is printed first (``in_crawl``).
The card's name and power limit come last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "dedup_deposit.cu"
OUT = ROOT / "build" / "dedup_deposit_variants"


def sources(also):
    """{variant name: source text}."""
    out = {"as_shipped": SOURCE.read_text()}
    for spec in also:
        name, path = spec.split("=", 1)
        out[name] = Path(path).read_text()
    return out


def build(texts):
    """One nvcc per variant, all started together; {name: the byte-per-bit
    C entry}."""
    from repro_torch.kernels.build import build_sources
    fns = {}
    for name, (lib, log) in build_sources(texts, OUT).items():
        fn = lib.dedup_deposit_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
    return fns


def wrapper(entry):
    """``dedup_deposit``'s signature around one variant's entry (the CUDA
    path of ``kernels.dedup_deposit.ops``)."""
    import torch

    def fn(bits, urls, mask, val, f_url, f_valid, table, *, k,
           url_tile=256):
        R, M = urls.shape
        seen = torch.empty((R, M), dtype=torch.bool, device=urls.device)
        refund = torch.empty((R,), dtype=torch.float32, device=urls.device)
        rc = entry(bits.data_ptr(), urls.data_ptr(), mask.data_ptr(),
                   val.data_ptr(), f_url.data_ptr(), f_valid.data_ptr(),
                   table.data_ptr(), seen.data_ptr(), refund.data_ptr(), R,
                   M, f_url.shape[1], k, bits.shape[1].bit_length() - 1,
                   min(url_tile, M), table.stride(0),
                   torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
        return seen, refund
    return fn


def in_crawl(sess, fns, steps=8):
    """{variant: device us of one launch inside the crawl}: each variant's
    entry takes the wrapper's place (``Kernel._fn``) for ``steps`` steps
    under torch.profiler, in the listed order and in reverse; the mean
    over both windows."""
    from chip_smoke import profile_device
    from repro_torch.kernels.dedup_deposit import ops
    saved = ops.KERNEL._fn
    us = {}
    try:
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                ops.KERNEL._fn = fns[name]
                prof = profile_device(
                    lambda: [sess.step() for _ in range(steps)], steps)
                hits = [v for key, v in prof["port_kernels"].items()
                        if "dedup_deposit_kernel" in key]
                n = sum(v["launches"] for v in hits)
                us.setdefault(name, []).append(
                    (1e3 * sum(v["ms_per_launch"] * v["launches"]
                               for v in hits), n))
    finally:
        ops.KERNEL._fn = saved
    return {name: sum(t for t, _ in v) / max(1, sum(n for _, n in v))
            for name, v in us.items()}


def drawn(rng, R=512, M=4096, C=4096, b=24, k=4):
    """A batch of every lane live, half re-sending URLs queued in a
    60%-valid queue, a quarter URLs inserted before and gone, on the card:
    (bits, urls, mask, val, f_url, f_valid, lane view)."""
    import torch
    from repro_torch.kernels.bloom.ref import bloom_ref
    f_url = rng.integers(1, 1 << 30, (R, C))
    f_valid = rng.random((R, C)) < 0.6
    gone = rng.integers(1 << 30, 1 << 31, (R, M))
    queued = np.take_along_axis(f_url, rng.integers(0, C, (R, M)), axis=1)
    pick = rng.random((R, M))
    urls = np.where(pick < 0.5, queued, np.where(pick < 0.75, gone,
                                                 rng.integers(1 << 31,
                                                              1 << 32,
                                                              (R, M))))
    dev = "cuda"
    bits = torch.zeros((R, 1 << b), dtype=torch.uint8, device=dev)
    bloom_ref(bits, torch.tensor(np.concatenate([f_url, gone], 1),
                                 device=dev),
              torch.ones((R, C + M), dtype=torch.bool, device=dev), k=k)
    wide = torch.zeros((R, C + 2), device=dev)
    wide[:, 2:] = torch.tensor(rng.random((R, C)) * f_valid,
                               dtype=torch.float32, device=dev)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return (bits, t(urls), torch.ones((R, M), dtype=torch.bool, device=dev),
            t(rng.random((R, M)).astype(np.float32)), t(f_url), t(f_valid),
            wide[:, 2:])


def resent_calls(sess, masks, seed):
    """Calls laid out as the captured ones (their masks), whose batches
    re-send URLs still queued in the lane's frontier, URLs of the batch
    before and fresh URLs, a third each (``chip_smoke.packed_batches``),
    made once by the plain version on the session's filter and lane, and
    recorded as ``capture_dedup`` records the crawl's calls."""
    import torch
    from chip_smoke import packed_batches
    from repro_torch.kernels.bloom.ref import _bit_indices
    from repro_torch.kernels.dedup_deposit.ref import dedup_deposit_ref
    from repro_torch.ordering.opic_url import url_cash_table
    st, cfg = sess.state, sess.cfg
    kh, b = cfg.bloom_hashes, cfg.bloom_bits_log2
    flat = st.bloom_bits.view(-1)
    table = url_cash_table(st)
    R, C = table.shape
    out = []
    for u, m, v in packed_batches(np.random.default_rng(seed), masks, st,
                                  len(masks) - 1, cfg.url_space_log2):
        rows = torch.nonzero(m)[:, :1]
        pos = torch.unique((rows * (1 << b) + _bit_indices(u, kh, b)[m])
                           .view(-1))
        lane = torch.empty((R, C + 2), device=table.device)[:, 2:]
        lane.copy_(table)
        c = {"urls": u, "mask": m, "val": v, "f_url": st.f_url,
             "f_valid": st.f_valid, "lane": lane, "lane0": lane.clone(),
             "pos": pos, "bits0": flat[pos].clone()}
        seen, refund = dedup_deposit_ref(st.bloom_bits, u, m, v, st.f_url,
                                         st.f_valid, lane, k=kh)
        c["crawl"] = (seen.clone(), refund.clone(), lane.clone())
        lane.copy_(c["lane0"])
        out.append(c)
    return out


def replay_times(fns, rep, label, kh):
    """Every variant held to the plain version on the replayed calls, then
    timed in a graph warm and cold."""
    from chip_smoke import HBM_BYTES_PER_S
    for name, fn in fns.items():
        rep.check(fn, name)
    live, seen, twins = rep.counts()
    n = len(rep.caps)
    out = {"input": label, "calls": n, "live_urls": live / n,
           "seen": seen / n, "twins": twins / n,
           "bound_us": 1e6 * rep.nbytes(kh) / HBM_BYTES_PER_S}
    for cold in (False, True):
        out[f"us_graph{'_cold' if cold else ''}"] = summary(timed(
            fns, lambda fn: rep.graph_ms(fn, cold=cold)))
    return out


def check_drawn(fns, case, k=4):
    """Every variant on the drawn batch against the plain version."""
    import torch
    from repro_torch.kernels.dedup_deposit.ref import dedup_deposit_ref
    bits, urls, mask, val, f_url, f_valid, lane = case
    want_bits, want_lane = bits.clone(), lane.clone()
    want = dedup_deposit_ref(want_bits, urls, mask, val, f_url, f_valid,
                             want_lane, k=k)
    for name, fn in fns.items():
        b2, l2 = bits.clone(), lane.clone()
        got = fn(b2, urls, mask, val, f_url, f_valid, l2, k=k)
        torch.cuda.synchronize()
        for a, b_, what in zip((*got, b2, l2), (*want, want_bits, want_lane),
                               ("seen", "refund", "filter", "lane")):
            if not torch.equal(a, b_):
                raise AssertionError(f"{name}: drawn batch: {what} differs "
                                     f"from the plain version")
    return int(want[0].sum())


def timed(fns, time_one):
    """{variant: [four times, us]}: two rounds in the listed order, two in
    reverse."""
    out = {}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            for _ in range(2):
                out.setdefault(name, []).append(1e3 * time_one(fns[name]))
    return out


def summary(times):
    return {"best": {n: min(t) for n, t in times.items()},
            "median": {n: float(np.median(t)) for n, t in times.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--also", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import (DEDUP_CALLS, PATHS, DedupReplay, capture_dedup,
                            fresh_graph_ms, fresh_urls, free_card,
                            nvidia_smi)
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    from repro_torch.ordering.opic_url import url_cash_table
    entries = build(sources(args.also))
    fns = {name: wrapper(e) for name, e in entries.items()}
    cfg = scaled(webparf.CONFIG, ordering="opic_url")
    sess = CrawlSession(cfg, device="cuda")
    sess.run(PATHS["opic_url"][0])
    print(json.dumps({"in_crawl": "webparf.CONFIG opic_url",
                      "us_per_launch": in_crawl(sess, entries)}), flush=True)
    kh = cfg.bloom_hashes
    rep = DedupReplay(sess.state.bloom_bits,
                      capture_dedup(sess, DEDUP_CALLS), kh)
    print(json.dumps(replay_times(fns, rep, "captured crawl calls", kh)),
          flush=True)
    masks = [c["mask"] for c in rep.caps]
    del rep
    rep = DedupReplay(sess.state.bloom_bits,
                      resent_calls(sess, masks, args.seed + 2), kh)
    print(json.dumps(replay_times(
        fns, rep, "the captured calls' masks re-sending queued URLs", kh)),
        flush=True)
    del rep
    # the same calls' masks with fresh URLs, against the live frontier
    st = sess.state
    lane = url_cash_table(st)
    rng = np.random.default_rng(args.seed)
    batches = [(u, m.clone(), torch.tensor(rng.random(m.shape),
                                           dtype=torch.float32,
                                           device="cuda"))
               for u, m in fresh_urls(rng, masks, len(masks) - 1, cfg)]
    out = {"input": "fresh URLs in the captured calls' masks",
           "calls": len(batches)}
    seeds = iter(range(args.seed + 100, args.seed + 10 ** 6))
    for cold in (False, True):
        out[f"us_graph{'_cold' if cold else ''}"] = summary(timed(
            fns, lambda fn: fresh_graph_ms(
                lambda u, m, v, fn=fn: fn(st.bloom_bits, u, m, v, st.f_url,
                                          st.f_valid, lane, k=kh),
                batches, cfg.url_space_log2, cold=cold, seed=next(seeds))))
    print(json.dumps(out), flush=True)
    del sess, st, lane, batches
    free_card()
    case = drawn(np.random.default_rng(args.seed + 1))
    n_seen = check_drawn(fns, case)
    bits, urls, mask, val, f_url, f_valid, lane = case
    copies = {}

    def once(fn):
        b2, l2 = copies.setdefault("b", bits.clone()), \
            copies.setdefault("l", lane.clone())
        b2.copy_(bits)
        l2.copy_(lane)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(b2, urls, mask, val, f_url, f_valid, l2, k=kh)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)
    print(json.dumps({"input": "drawn: 512 x 4096 live, 60%-valid queue",
                      "seen": n_seen,
                      "us_events": summary(timed(fns, once))}), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
