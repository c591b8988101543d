#!/usr/bin/env python3
"""Time the pop kernels' (frontier_select, select_harvest) design choices
against each other on one NVIDIA card, in one run.

    python3 tools/frontier_select_variants.py [--also NAME=old.cu]

Builds ``src/repro_torch/csrc/frontier_select.cu`` as it stands and with
one of its choices changed at a time (each a constant of the source,
replaced in a copy under ``build/``):

- ``8_cells_a_thread`` / ``32_cells_a_thread``: a thread holds 8 or 32
  cells of a chunk, where the source gives it 16 (so 512 or 128 threads a
  row at C = 4096, where the source takes 256);
- ``1024_threads_a_row``: 4 cells a thread and up to 1024 threads a row;
- ``one_row_a_block``: a block holds one row however short, where the
  source packs rows of fewer than 256 threads into 256-thread blocks;
- ``dense_loads``: every priority loaded, where the source loads a float4
  of priorities only where one of its four flags is set;
- ``no_register_cap``: registers as the compiler likes, where the source
  caps them at 64 a thread (it matters to the scalar path, which
  ``scalar_loads_no_register_cap`` takes);

and ``scalar_loads``, the source as it stands called with its vector path
off (a cell a load). ``--also`` adds any other source with the same C
entries, such as an earlier commit's (``git show
<rev>:src/repro_torch/csrc/frontier_select.cu > build/old.cu``); a source
whose entries take no ``vec`` argument is called without it.

Inputs: the frontiers that ``chip_smoke.py`` times, captured the same
way from crawls at ``webparf.CONFIG`` (512 rows x 4,096 cells, k = 1):
the backlink path's after 32 steps (``frontier_select``) and the
opic_url path's with its url cash lane after 64 steps
(``select_harvest``): about 1-2% of their cells are valid; then, drawn
from a seed with numpy with 60% of the cells valid, the full width at k
= 1 and at k = 8 (every round reads the row again in a kernel that keeps
nothing resident), the CLI's width (64 rows x 512, k = 1) and the
reduced config's (16 x 64, k = 1). Every variant must equal the plain
version (``ref.select_ref``, ``ref.select_harvest_ref``) exactly on
every input, every output and every tensor it updates in place. Beside
the variants, the library call that computes the same pop
(``torch.topk`` of the masked keys, and for the harvest a
``torch.gather`` of the lane) is timed the same ways. Times, in
microseconds a call, by ``chip_smoke.pop_times`` (every copy of the
inputs restored before each timed run): back-to-back CUDA events
(``events``); 48 calls cycling over 8 copies in one CUDA graph
(``graph``, warm); one call on each of 48 copies in one graph with the
L2 flushed first (``graph_cold``); the device time by torch.profiler
(``device``); best and median of four, two in the listed order and two
in reverse; the bound (``chip_smoke.pop_bytes`` over 3.35 TB/s) beside
them. Before the inputs are timed, each variant also takes the
wrapper's place in the crawl that captured them, for 8 steps under
torch.profiler in each order, and the device time of one pop launch
there is printed first (``in_crawl``). The card's name and power limit
come last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "frontier_select.cu"
OUT = ROOT / "build" / "frontier_select_variants"
# name -> [(text in the source, its replacement)]
CHANGES = {
    "8_cells_a_thread": [("kVecPerThread = 4;", "kVecPerThread = 2;")],
    "32_cells_a_thread": [("kVecPerThread = 4;", "kVecPerThread = 8;")],
    "1024_threads_a_row": [("kVecPerThread = 4;", "kVecPerThread = 1;"),
                           ("kMaxRowThreads = 512;",
                            "kMaxRowThreads = 1024;")],
    "one_row_a_block": [("kBlockThreads = 256;", "kBlockThreads = 32;")],
    "dense_loads": [("kSkipInvalid = true;", "kSkipInvalid = false;")],
    "no_register_cap": [("kThreadsPerSM = 1024;", "kThreadsPerSM = 1;")],
}


def sources(also):
    """{variant name: source text}."""
    text = SOURCE.read_text()
    out = {"as_shipped": text}
    for name, edits in CHANGES.items():
        t = text
        for old, new in edits:
            if t.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {SOURCE} once")
            t = t.replace(old, new)
        out[name] = t
    for spec in also:
        name, path = spec.split("=", 1)
        out[name] = Path(path).read_text()
    return out


def takes_vec(text):
    """Whether the source's frontier_select_launch takes the vec flag."""
    sig = re.search(r"frontier_select_launch\(([^)]*)\)", text).group(1)
    return "vec" in sig


def build(texts):
    """One nvcc per variant, all started together; {name: (select entry,
    harvest entry, takes vec)}."""
    from repro_torch.kernels.build import build_sources
    fns = {}
    for name, (lib, log) in build_sources(texts, OUT).items():
        vec = takes_vec(texts[name])
        sel, har = lib.frontier_select_launch, lib.select_harvest_launch
        sel.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * (3 + vec) \
            + [ctypes.c_void_p]
        har.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * (4 + vec) \
            + [ctypes.c_void_p]
        sel.restype = har.restype = ctypes.c_int
        fns[name] = (sel, har, vec)
        print(json.dumps({"variant": name, "ptxas": ptxas(log)}),
              flush=True)
    return fns


def ptxas(log):
    """{kernel<threads a row, vector path>: ptxas's spill and registers
    lines}."""
    out, name, spill = {}, None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function .*(frontier_select|"
                      r"select_harvest)_kernelI(?:Li(\d+)E)?Lb(\d)E", ln)
        if m:
            name = f"{m[1]}<{m[2]},{m[3]}>"
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and name:
            out[name] = f"{spill}; {ln.split(':', 1)[-1].strip()}"
            name = None
    return out


def caller(entry, url, pri, valid, table, k, vec):
    """A call of one variant's entry on these tensors (outputs made per
    call); returns the outputs."""
    import torch
    sel, har, takes = entry
    R, C = url.shape
    extra = [int(vec)] if takes else []

    def call():
        dev = url.device
        outs = [torch.empty((R, k), dtype=dt, device=dev)
                for dt in (torch.int64, torch.float32, torch.bool,
                           torch.int64)]
        stream = torch.cuda.current_stream().cuda_stream
        if table is None:
            rc = sel(url.data_ptr(), pri.data_ptr(), valid.data_ptr(),
                     *(o.data_ptr() for o in outs), R, C, k, *extra, stream)
        else:
            outs.append(torch.empty((R, k), dtype=torch.float32, device=dev))
            o = [x.data_ptr() for x in outs]
            rc = har(url.data_ptr(), pri.data_ptr(), valid.data_ptr(),
                     table.data_ptr(), *o, R, C, k, table.stride(0), *extra,
                     stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
        return outs
    return call


def library(url, pri, valid, table, k):
    """torch.topk of the masked keys (and a gather of the lane)."""
    import torch
    from repro_torch.kernels.frontier_select.ref import NEG

    def call():
        idx = torch.topk(torch.where(valid, pri, NEG), k, dim=1).indices
        return idx if table is None else torch.gather(table, 1, idx)
    return call


def in_crawl(sess, fns, steps=8):
    """{variant: device us of one pop launch inside the crawl}: each
    variant's entries take the wrapper's place (``Kernel._fn``) for
    ``steps`` steps of ``sess`` under torch.profiler, twice, in the listed
    order and in reverse; the mean over both windows."""
    from chip_smoke import profile_device
    from repro_torch.kernels.frontier_select import ops
    saved = ops.KERNEL._fn, ops.HARVEST._fn
    us = {}
    try:
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                sel, har, takes = fns[name]
                # the wrapper passes (..., vec, stream); an entry without
                # vec gets (..., stream)
                ops.KERNEL._fn = sel if takes else \
                    (lambda f: lambda *a: f(*a[:10], a[-1]))(sel)
                ops.HARVEST._fn = har if takes else \
                    (lambda f: lambda *a: f(*a[:13], a[-1]))(har)
                prof = profile_device(
                    lambda: [sess.step() for _ in range(steps)], steps)
                pops = [v for k, v in prof["port_kernels"].items()
                        if "frontier_select_kernel" in k
                        or "select_harvest_kernel" in k]
                n = sum(v["launches"] for v in pops)
                us.setdefault(name, []).append(
                    (1e3 * sum(v["ms_per_launch"] * v["launches"]
                               for v in pops), n))
    finally:
        ops.KERNEL._fn, ops.HARVEST._fn = saved
    return {name: sum(t for t, _ in v) / sum(n for _, n in v)
            for name, v in us.items()}


def captured(fns):
    """{name: (url, pri, valid, table or None, k)} from CONFIG crawls, and
    {ordering: in_crawl(...)} measured on the same sessions after."""
    from chip_smoke import PATHS, free_card
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    from repro_torch.ordering.opic_url import url_cash_table
    out, crawl = {}, {}
    for ordering in ("backlink", "opic_url"):
        sess = CrawlSession(scaled(webparf.CONFIG, ordering=ordering),
                            device="cuda")
        sess.run(PATHS[ordering][0])
        st = sess.state
        table = url_cash_table(st).clone() if ordering == "opic_url" \
            else None
        out[f"{ordering}_captured"] = (st.f_url.clone(), st.f_pri.clone(),
                                       st.f_valid.clone(), table, 1)
        crawl[ordering] = in_crawl(sess, fns)
        del sess, st
        free_card()
    return out, crawl


def drawn(seed):
    """{name: (url, pri, valid, None, k)} on the card, from numpy."""
    import torch
    from chip_smoke import frontier_rows
    rng = np.random.default_rng(seed)
    out = {}
    for name, (R, C, k) in (("config_dense", (512, 4096, 1)),
                            ("config_k8", (512, 4096, 8)),
                            ("cli", (64, 512, 1)), ("reduced", (16, 64, 1))):
        url, pri, valid = frontier_rows(rng, R, C)
        out[name] = (torch.tensor(url, device="cuda"),
                     torch.tensor(pri, device="cuda"),
                     torch.tensor(valid, device="cuda"), None, k)
    return out


def check(name, case, call_on, inputs):
    """The variant on a fresh copy against the plain version."""
    import torch
    from repro_torch.kernels.frontier_select.ref import (select_harvest_ref,
                                                         select_ref)
    url, pri, valid, table, k = inputs
    mine = [x.clone() if x is not None else None for x in (pri, valid, table)]
    ref = [x.clone() if x is not None else None for x in (pri, valid, table)]
    got = call_on(*mine)()
    if table is None:
        want = select_ref(url, ref[0], ref[1], k=k, return_idx=True)
    else:
        want = select_harvest_ref(url, *ref, k=k)
    torch.cuda.synchronize()
    for a, b in zip((*got, *mine), (*want, *ref)):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{name} differs from the plain version on "
                                 f"{case}")


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
    from chip_smoke import HBM_BYTES_PER_S, nvidia_smi, pop_bytes, pop_times
    from repro_torch.kernels.frontier_select.ops import vector_path
    fns = build(sources(args.also))
    cap, crawl = captured(fns)
    for ordering, us in crawl.items():
        print(json.dumps({"in_crawl": f"webparf.CONFIG {ordering}",
                          "us_per_launch": us}), flush=True)
    cases = {**cap, **drawn(args.seed)}
    for case, inputs in cases.items():
        url, pri, valid, table, k = inputs
        vec = vector_path(pri, valid)
        # name -> a function of (pri, valid, table) giving the call
        runs = {}
        for name, entry in fns.items():
            runs[name] = (lambda e: lambda p, v, t: caller(
                e, url, p, v, t, k, vec))(entry)
        runs["scalar_loads"] = lambda p, v, t: caller(
            fns["as_shipped"], url, p, v, t, k, False)
        runs["scalar_loads_no_register_cap"] = lambda p, v, t: caller(
            fns["no_register_cap"], url, p, v, t, k, False)
        for name, call_on in runs.items():
            check(name, case, call_on, inputs)
        runs["library"] = lambda p, v, t: library(url, p, v, t, k)
        tensors = (pri, valid) if table is None else (pri, valid, table)
        times = {}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                for _ in range(2):
                    t = pop_times(lambda *c, f=runs[name]: f(
                        c[0], c[1], c[2] if len(c) > 2 else None), tensors)
                    for key, ms in t.items():
                        times.setdefault(name, {}).setdefault(
                            key, []).append(1e3 * ms)
        R, C = url.shape
        out = {"input": case, "shape": [R, C], "k": k,
               "kernel": "select_harvest" if table is not None
               else "frontier_select",
               "vector_path": bool(vec), "valid_cells": int(valid.sum())}
        nbytes, dense = pop_bytes(valid, k, harvest=table is not None)
        out.update(bound_us=1e6 * nbytes / HBM_BYTES_PER_S,
                   dense_bound_us=1e6 * dense / HBM_BYTES_PER_S)
        for key in ("graph_ms", "graph_cold_ms", "device_ms", "events_ms"):
            tag = key[:-3]
            out[f"us_{tag}_best"] = {n: min(t[key])
                                     for n, t in times.items()}
            out[f"us_{tag}_median"] = {n: float(np.median(t[key]))
                                       for n, t in times.items()}
        print(json.dumps(out), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
