#!/usr/bin/env python3
"""Time the opic_update kernel's design choices against each other on one
NVIDIA card, in one run.

    python3 tools/opic_update_variants.py [--also NAME=path/to/opic_update.cu]

Builds ``src/repro_torch/csrc/opic_update.cu`` as it stands and with one of
its choices changed at a time (each a constant of the source, replaced in a
copy under ``build/``):

- ``512_threads`` / ``256_threads``: one block size for every grid, where
  the source takes 512 threads for a grid of fewer than 132 blocks and 256
  for more;
- ``no_warp_path``: a chunk of at most 32 live items takes the sort as any
  other, where the source groups it in one warp;
- ``no_range_split``: one range block a batch row whenever the row's
  targets fit one, where the source splits a small grid toward 16 blocks.

``--also`` adds any other source with the same C entry
(``opic_update_launch``), such as an earlier commit's
(``git show <rev>:src/repro_torch/csrc/opic_update.cu > build/old.cu``).

Inputs: the two scatters that ``chip_smoke.py`` times, captured the same
way from crawls at ``webparf.CONFIG`` (the opic spend after 16 steps of
``ordering="opic"``, 1 x 8,192 items onto 512 slots; the dispatch's cell
scatter after 64 steps of ``"opic_url"``, 512 rows x 4,096 items onto
4,096 cells); then, drawn from a seed with numpy, a spend with its live
items spread at random (48% live, slots drawn with weight 1 / rank^0.8, so
the busiest takes ~300 items), cells with 4 live items a row at random
places on distinct cells, and the same with 64. Every variant must equal
the plain version (``opic_ref``) exactly on every input. Each variant is
timed as 100 calls in one CUDA graph (``chip_smoke.graph_ms``), six times
in all, half in the listed order and half in reverse; the line per input
gives the best and the median microseconds a call. The card's name and
power limit come last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "opic_update.cu"
OUT = ROOT / "build" / "opic_update_variants"
# name -> (text in the source, its replacement)
CHANGES = {
    "512_threads": ("kManyBlocks = 132", "kManyBlocks = (1 << 30)"),
    "256_threads": ("kManyBlocks = 132", "kManyBlocks = 0"),
    "no_warp_path": ("if (nl <= 32) {", "if (nl <= 0) {"),
    "no_range_split": ("kMinBlocks = 16", "kMinBlocks = 1"),
}


def sources(also):
    """{variant name: source text}."""
    text = SOURCE.read_text()
    out = {"as_shipped": text}
    for name, (old, new) in CHANGES.items():
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in {SOURCE} once")
        out[name] = text.replace(old, new)
    for spec in also:
        name, path = spec.split("=", 1)
        out[name] = Path(path).read_text()
    return out


def build(texts):
    """One nvcc per variant, all started together; {name: C entry}."""
    from repro_torch.kernels.build import build_sources
    fns = {}
    for name, (lib, _) in build_sources(texts, OUT).items():
        fn = lib.opic_update_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def captured():
    """{name: (cash, rows, contrib, mask)}: the spend and the cell scatter
    as the crawl paths hand them to the kernel."""
    import torch
    from chip_smoke import PATHS, capture_calls, free_card
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    from repro_torch.core import frontier as F
    from repro_torch.ordering import opic as OP
    out = {}
    for ordering in ("opic", "opic_url"):
        sess = CrawlSession(scaled(webparf.CONFIG, ordering=ordering),
                            device="cuda")
        sess.run(PATHS[ordering][0])
        if ordering == "opic":
            (args, _), = capture_calls([OP], "scatter_cash", sess.step, 1)
            out["spend_captured"] = tuple(a.contiguous() for a in args)
        else:
            (args, _), = capture_calls([F], "scatter_cash_cells", sess.step,
                                       1, pick=lambda a: a[2].shape[1] > 1)
            table, _, cols, vals, fits = args
            ok = fits & (cols >= 0) & (cols < table.shape[1])
            out["cells_captured"] = (table.contiguous(),
                                     cols.to(torch.int64).contiguous(),
                                     vals.contiguous(), ok.contiguous())
        del sess
        free_card()
    return out


def drawn(seed):
    """{name: (cash, rows, contrib, mask)} on the card, from numpy."""
    import torch
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, 513) ** 0.8
    spend = (rng.random((1, 512)), rng.choice(512, (1, 8192), p=w / w.sum()),
             rng.random((1, 8192)) / 64, rng.random((1, 8192)) < 0.48)

    def cells(live):
        R, N = 512, 4096
        cols = rng.integers(0, N, (R, N))
        mask = np.zeros((R, N), bool)
        for r in range(R):
            at = rng.choice(N, live, replace=False)
            mask[r, at] = True
            cols[r, at] = rng.choice(N, live, replace=False)
        return rng.random((R, N)), cols, rng.random((R, N)), mask
    out = {}
    for name, (cash, rows, contrib, mask) in (
            ("spend", spend), ("cells", cells(4)), ("cells_64", cells(64))):
        out[name] = (torch.tensor(cash, dtype=torch.float32, device="cuda"),
                     torch.tensor(rows, dtype=torch.int64, device="cuda"),
                     torch.tensor(contrib, dtype=torch.float32,
                                  device="cuda"),
                     torch.tensor(mask, device="cuda"))
    return out


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
    from chip_smoke import graph_ms, nvidia_smi
    from repro_torch.kernels.opic_update.ref import opic_ref
    fns = build(sources(args.also))
    cases = {**captured(), **drawn(args.seed)}
    for case, (cash, rows, contrib, mask) in cases.items():
        B, N = rows.shape
        want = opic_ref(cash.clone(), rows, contrib, mask)
        times = {}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                fn, c = fns[name], cash.clone()

                def call():
                    rc = fn(c.data_ptr(), rows.data_ptr(),
                            contrib.data_ptr(), mask.data_ptr(), B,
                            cash.shape[1], N, c.stride(0), 256,
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                call()
                if not torch.equal(c, want):
                    raise AssertionError(f"{name} differs from opic_ref on "
                                         f"{case}")
                times.setdefault(name, []).extend(
                    1e3 * graph_ms(call, 100) for _ in range(3))
        print(json.dumps({"input": case, "shape": [B, cash.shape[1], N],
                          "live": int(mask.sum()),
                          "us_best": {k: min(t) for k, t in times.items()},
                          "us_median": {k: sorted(t)[len(t) // 2]
                                        for k, t in times.items()}}),
              flush=True)
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
