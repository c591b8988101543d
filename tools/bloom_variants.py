#!/usr/bin/env python3
"""Time bloom and bloom_packed as they stand against other sources of them
on one NVIDIA card, in one run.

    python3 tools/bloom_variants.py [--also NAME=old.cu]

Builds ``src/repro_torch/csrc/bloom.cu`` as it stands (``as_shipped``) and
each ``--also`` source with the same C entries (``bloom_launch``,
``bloom_packed_launch``), such as an earlier commit's (``git show
<rev>:src/repro_torch/csrc/bloom.cu > build/parent.cu``) or a copy with one
design choice reversed.

Inputs, from a crawl at ``webparf.CONFIG`` (``ordering="backlink"``, 512
Bloom rows of 2^24 bytes, 32 steps): the masks of the next
``chip_smoke.BLOOM_MASKS`` dispatches, captured as ``core/dedup.py`` hands
them to the kernel (about 4 live lanes a row, packed at its front), 48
batches cycling over them, with fresh URLs; the same masks re-sending,
a third each, URLs still queued in the frontier, URLs of the batch before
and fresh URLs (``chip_smoke.packed_batches``); and, drawn from a seed
with numpy, 512 rows x 4,096 lanes, every lane live, half of them URLs
inserted before, on a filter of its own. Each input also goes through the
packed layout, on the same filter packed into int32 words. Every variant
must equal the plain version (``ref.bloom_ref``, ``ref.bloom_packed_ref``)
with torch.equal on every seen and on the whole filter, on each input,
before it is timed.

Times, in microseconds a call, best and median of four (two in the listed
order, two in reverse): the fresh batches in one CUDA graph, their URLs
made fresh before each replay (``chip_smoke.fresh_graph_ms``), warm and with the L2 flushed (``cold``);
``dedup_deposit`` on the fresh batches (the same Bloom walk plus the twin
match and deposits) beside the shipped ``bloom``, as a yardstick; the
re-sending batches and the drawn batch in a graph with every filter byte
(word) they touch restored before each replay, warm and cold; each beside
the bytes its data needs over 3.35 TB/s. First, each variant takes the
wrapper's place in the crawl for 16 steps (four dispatches) under
torch.profiler, in the listed order and in reverse, and the device time of
one launch there is printed (``in_crawl``). The card's name and power
limit come last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "bloom.cu"
OUT = ROOT / "build" / "bloom_variants"
CALLS = 48      # batches a timing graph holds, cycling over the masks


def sources(also):
    """{variant name: source text}."""
    out = {"as_shipped": SOURCE.read_text()}
    for spec in also:
        name, path = spec.split("=", 1)
        out[name] = Path(path).read_text()
    return out


def build(texts):
    """One nvcc per variant, all started together; {name: {layout: C
    entry}} for the layouts "byte" and "packed"."""
    from repro_torch.kernels.build import build_sources
    out = {}
    for name, (lib, log) in build_sources(texts, OUT).items():
        out[name] = {}
        for layout, sym in (("byte", "bloom_launch"),
                            ("packed", "bloom_packed_launch")):
            fn = getattr(lib, sym)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out[name][layout] = fn
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
    return out


def wrapper(entry):
    """``probe_insert``'s signature around one variant's entry (the CUDA
    path of ``kernels.bloom.ops``); the layout follows the filter's
    dtype."""
    import torch

    def fn(filt, urls, mask, *, k, url_tile=256):
        R, M = urls.shape
        nbits = filt.shape[1] * (32 if filt.dtype == torch.int32 else 1)
        seen = torch.empty((R, M), dtype=torch.bool, device=urls.device)
        rc = entry(filt.data_ptr(), urls.data_ptr(), mask.data_ptr(),
                   seen.data_ptr(), R, M, k, nbits.bit_length() - 1,
                   min(url_tile, M), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
        return seen
    return fn


def in_crawl(sess, entries, steps=16):
    """{variant: device us of one launch inside the crawl}: each variant's
    byte-per-bit entry takes the wrapper's place (``Kernel._fn``) for
    ``steps`` steps under torch.profiler, in the listed order and in
    reverse; the mean over both windows."""
    from chip_smoke import PORT_KERNEL_FNS, profile_device
    from repro_torch.kernels.bloom import ops
    saved = ops.KERNEL._fn
    us = {}
    try:
        for order in (list(entries), list(entries)[::-1]):
            for name in order:
                ops.KERNEL._fn = entries[name]["byte"]
                prof = profile_device(
                    lambda: [sess.step() for _ in range(steps)], steps)
                hits = [v for key, v in prof["port_kernels"].items()
                        if PORT_KERNEL_FNS["bloom"] in key]
                us.setdefault(name, []).append(
                    (1e3 * sum(v["ms_per_launch"] * v["launches"]
                               for v in hits),
                     sum(v["launches"] for v in hits)))
    finally:
        ops.KERNEL._fn = saved
    return {name: sum(t for t, _ in v) / max(1, sum(n for _, n in v))
            for name, v in us.items()}


def touched(filt, batches, k):
    """The flat indices into ``filt`` (bytes, or words packed) that the
    batches' live URLs probe, each once."""
    import torch
    from repro_torch.kernels.bloom.ref import _bit_indices
    packed = filt.dtype == torch.int32
    nbits = filt.shape[1] * (32 if packed else 1)
    b = nbits.bit_length() - 1
    pos = []
    for u, m in batches:
        rows = torch.nonzero(m)[:, :1]
        p = rows * nbits + _bit_indices(u, k, b)[m]
        pos.append((p >> 5 if packed else p).view(-1))
    return torch.unique(torch.cat(pos))


class Restored:
    """The filter words or bytes a list of batches touches, saved, so that
    ``restore()`` puts the filter back as it was before them."""

    def __init__(self, filt, batches, k):
        self.flat = filt.view(-1)
        self.pos = touched(filt, batches, k)
        self.saved = self.flat[self.pos].clone()

    def restore(self):
        self.flat[self.pos] = self.saved


def check(fns, filt, batches, k, label):
    """Every variant on ``batches`` in order against the plain version,
    from the same filter: torch.equal on each seen and on the whole filter
    (so a write outside the probed positions shows too); the filter is
    left as it was. Returns the seen URLs over the batches."""
    import torch
    from repro_torch.kernels.bloom.ref import bloom_packed_ref, bloom_ref
    ref = bloom_packed_ref if filt.dtype == torch.int32 else bloom_ref
    rs = Restored(filt, batches, k)
    want_f = filt.clone()
    want = [ref(want_f, u, m, k=k) for u, m in batches]
    for name, fn in fns.items():
        got = [fn(filt, u, m, k=k) for u, m in batches]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want)) and \
            torch.equal(filt, want_f)
        rs.restore()
        if not same:
            raise AssertionError(f"{name}: {label}: differs from the plain "
                                 f"version")
    del want_f
    return sum(int(s.sum()) for s in want)


def bound_us(filt, batches, k):
    """The bytes the batches need (``chip_smoke.bloom_bytes``, k words a
    live URL packed) plus the bytes or words they newly set, over the
    card's rate, in us a call; and the live URLs a call."""
    import torch
    from chip_smoke import HBM_BYTES_PER_S, bloom_bytes
    packed = filt.dtype == torch.int32
    b = (filt.shape[1] * (32 if packed else 1)).bit_length() - 1
    nbytes, n_live, _ = bloom_bytes(batches, k, b, word_bytes=4 if packed
                                    else 1)
    from repro_torch.kernels.bloom.ref import bloom_packed_ref, bloom_ref
    ref = bloom_packed_ref if packed else bloom_ref
    rs = Restored(filt, batches, k)
    for u, m in batches:
        ref(filt, u, m, k=k)
    n_new = int((rs.flat[rs.pos] != rs.saved).sum())
    rs.restore()
    n = len(batches)
    return (1e6 * (nbytes + (4 if packed else 1) * n_new) / n
            / HBM_BYTES_PER_S, n_live / n)


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


def restored_times(fns, filt, batches, k):
    """Each variant on ``batches`` in one graph, the touched filter
    restored before every replay, warm and with the L2 flushed."""
    import torch
    from chip_smoke import DEV, FLUSH_BYTES, replay_ms
    rs = Restored(filt, batches, k)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    out = {}
    for cold in (False, True):
        def before():
            rs.restore()
            if cold:
                flush.fill_(0)
        out[f"us_graph{'_cold' if cold else ''}"] = summary(timed(
            fns, lambda fn: replay_ms([lambda b=b: fn(filt, *b, k=k)
                                       for b in batches], before)))
    rs.restore()
    return out


def drawn(rng, R=512, M=4096, b=24, k=4):
    """Every lane live, half of them URLs inserted before, on a filter of
    its own: (bits, [(urls, mask)])."""
    import torch
    from repro_torch.kernels.bloom.ref import bloom_ref
    old = rng.integers(0, 1 << 30, (R, M))
    urls = np.where(rng.random((R, M)) < 0.5, old,
                    rng.integers(1 << 30, 1 << 31, (R, M)))
    bits = torch.zeros((R, 1 << b), dtype=torch.uint8, device="cuda")
    bloom_ref(bits, torch.tensor(old, device="cuda"),
              torch.ones((R, M), dtype=torch.bool, device="cuda"), k=k)
    return bits, [(torch.tensor(urls, device="cuda"),
                   torch.ones((R, M), dtype=torch.bool, device="cuda"))]


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
    from chip_smoke import (BLOOM_MASKS, PATHS, capture_dispatch_masks,
                            fresh_graph_ms, fresh_urls, free_card,
                            nvidia_smi, packed_batches)
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    from repro_torch.kernels.bloom.ref import pack_bits
    from repro_torch.kernels.dedup_deposit.ops import dedup_deposit
    entries = build(sources(args.also))
    fns = {layout: {name: wrapper(e[layout]) for name, e in entries.items()}
           for layout in ("byte", "packed")}
    cfg = scaled(webparf.CONFIG, ordering="backlink")
    sess = CrawlSession(cfg, device="cuda")
    sess.run(PATHS["backlink"][0])
    print(json.dumps({"in_crawl": "webparf.CONFIG backlink",
                      "us_per_launch": in_crawl(sess, entries)}), flush=True)
    kh = cfg.bloom_hashes
    st = sess.state
    masks = capture_dispatch_masks(sess, BLOOM_MASKS)
    filt = {"byte": st.bloom_bits, "packed": pack_bits(st.bloom_bits)}
    rng = np.random.default_rng(args.seed)
    seeds = iter(range(args.seed + 100, args.seed + 10 ** 6))
    fresh = fresh_urls(rng, masks, CALLS - 1, cfg)
    label = "fresh URLs in the captured dispatch masks"
    for layout in ("byte", "packed"):
        f = filt[layout]
        out = {"input": label, "layout": layout, "calls": len(fresh),
               "seen": check(fns[layout], f, fresh, kh, label)}
        out["bound_us"], out["live_urls"] = bound_us(f, fresh, kh)
        for cold in (False, True):
            bs = [(u, m.clone() if cold else m) for u, m in fresh]
            out[f"us_graph{'_cold' if cold else ''}"] = summary(timed(
                fns[layout], lambda fn: fresh_graph_ms(
                    lambda u, m, fn=fn: fn(f, u, m, k=kh), bs,
                    cfg.url_space_log2, cold=cold, seed=next(seeds))))
        print(json.dumps(out), flush=True)
    # the yardstick: dedup_deposit (the same Bloom walk, the twin match and
    # the deposits) on the same fresh batches, beside the shipped bloom;
    # against an empty queue, so that a URL the refreshes bring back costs
    # a refund, not a scan of the row's queue
    lane = torch.zeros(st.f_url.shape, dtype=torch.float32, device="cuda")
    empty = torch.zeros_like(st.f_valid)
    vals = [torch.tensor(rng.random(m.shape), dtype=torch.float32,
                         device="cuda") for _, m in fresh]
    yard = {"dedup_deposit": lambda u, m, v: dedup_deposit(
                st.bloom_bits, u, m, v, st.f_url, empty, lane, k=kh),
            "bloom": lambda u, m, v: fns["byte"]["as_shipped"](
                st.bloom_bits, u, m, k=kh)}
    out = {"input": "fresh URLs in the captured dispatch masks, yardstick"}
    for cold in (False, True):
        batches = [(u, m.clone() if cold else m, v)
                   for (u, m), v in zip(fresh, vals)]
        out[f"us_graph{'_cold' if cold else ''}"] = summary(timed(
            yard, lambda fn: fresh_graph_ms(fn, batches, cfg.url_space_log2,
                                            cold=cold, seed=next(seeds))))
    print(json.dumps(out), flush=True)
    # re-sending queued URLs and the batch before's, on both layouts
    resent = [(u, m) for u, m, _ in packed_batches(
        rng, masks, st, CALLS - 1, cfg.url_space_log2)]
    for layout in ("byte", "packed"):
        f = filt[layout]
        out = {"input": "the captured masks re-sending queued URLs and the "
                        "batch before's", "layout": layout,
               "calls": len(resent),
               "seen": check(fns[layout], f, resent, kh, "re-sending")}
        out["bound_us"], out["live_urls"] = bound_us(f, resent, kh)
        out.update(restored_times(fns[layout], f, resent, kh))
        print(json.dumps(out), flush=True)
    del sess, st, filt, fresh, resent, lane, empty, vals, yard
    free_card()
    bits, batch = drawn(np.random.default_rng(args.seed + 1))
    for layout in ("byte", "packed"):
        f = bits if layout == "byte" else pack_bits(bits)
        out = {"input": "drawn: 512 x 4096 all live, half inserted before",
               "layout": layout,
               "seen": check(fns[layout], f, batch, kh, "drawn batch")}
        out["bound_us"], out["live_urls"] = bound_us(f, batch, kh)
        out.update(restored_times(fns[layout], f, batch, kh))
        print(json.dumps(out), flush=True)
        del f
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
