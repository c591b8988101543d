"""The dry run on one card: every cell reckoned on ``meta``, nothing
allocated. Counterpart of ``repro/launch/dryrun.py``.

The reference lowers and compiles each (architecture x input shape) cell
against abstract shapes on a production mesh and reads its memory and
cost from XLA. PyTorch has no lowering to read, so each cell
(``specs.build_cell``) runs on ``meta`` tensors: every op computes its
outputs' shapes and dtypes and allocates nothing, and

- a live-bytes tracker (``LiveBytes``, a ``TorchDispatchMode``) counts
  each new storage when an op makes it and frees it when the last tensor
  on it dies, rounded up to 512 bytes as the card's caching allocator
  rounds, so its peak is what ``torch.cuda.max_memory_allocated`` would
  read over the step's own allocations; the same allocations and frees,
  after the arguments', replay the card's caching allocator
  (``CachingAllocator``), whose segments are what runs out on the card;
- ``torch.utils.flop_counter.FlopCounterMode`` counts the matmuls'
  operations, and the kernels' meta routes (``kernels.registry``) add the
  work of the hand-written kernels, which it does not see;
- ``hbm_bytes_est`` adds each op's operand and result bytes (an eager
  step's traffic: nothing is fused), and ``bound_ms`` is the larger of
  the bytes the step must move (its arguments read once, its results
  written once) over 3.35 TB/s and its operations over the peak of its
  dtype (bf16 989 TFLOP/s; f32 67 TFLOP/s, TF32 off), ``launch/mesh.py``.

The record keeps the reference's fields where they have a meaning here:
``arch``, ``shape``, ``variant``, ``n_devices`` (1), ``meta``,
``memory`` (``argument_size_in_bytes``, ``output_size_in_bytes``,
``temp_size_in_bytes``, ``total_per_device``, as ``_mem_dict``),
``cost.flops`` and ``hbm_bytes_est``; and adds ``memory.reserved_needed``
and ``memory.reserved_peak`` (the allocator's segments), ``devices``
(those of the arguments and of every op's results: ``["meta"]``),
``bound_ms``, ``fits`` (``reserved_needed`` against ``mesh.HBM_BYTES``,
the 78.48 GiB a cell can allocate on the card) and, when a cell does not
fit, ``largest_batch_that_fits`` (halving its batch).

The crawl cell (``webparf crawl_step`` at ``webparf.CONFIG``, 1 and 4
shards) reckons its state on meta exactly; its step reads the host
(``core/frontier.py``'s rebase guard and boolean-mask inserts,
``core/router.py``'s and ``core/stages.py``'s ``nonzero``), which meta
cannot answer, so its temporaries are reckoned from ``CrawlConfig``'s
buffer sizes (``crawl_temporaries``); the record says so.

Under a mesh (``--mesh single|multi|both|<dp>x<tp>``: the reference's
(16, 16) and (2, 16, 16) on ("pod", "data", "model"), or a (data, model)
shape) each cell is reckoned per card: as the program of process 0 of
the mesh (``mesh_record(rank=)`` reckons another), with the same code
the cards run, on meta under a ``sharding.spmd.MetaMesh`` (the mesh's
shape and that process's coordinate, no process group): its arguments are that
process's blocks (``specs.build_cell(..., mesh=)``: parameters and
optimizer state by ``sharding/rules.py``, its rows of the batch, its
segment of a KV cache by ``rules.cache_specs``; the crawl cell at one
shard a data process, its rows by ``state_specs`` and its temporaries by
``crawl_temporaries`` at its one shard), and every collective it makes
takes its meta route, counted by kind and operand bytes: the record's
``collectives`` and ``collective_bytes`` (the crawl's exchange reckoned
from its buffers). ``memory``, ``fits`` and ``largest_batch_that_fits``
are that card's; ``cost.flops`` and ``bound_ms`` that card's work
against that card's rates (no link rate is assumed). A mesh of one card
is the one-card program. Cells whose mesh program the port does not run
(``specs.mesh_program``: the RecSys serving and retrieval cells and the
GAT's full graphs) get a record that says ``"mesh_program": "not
ported"`` and why. Without ``--mesh`` the records are the one-card ones.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all         # 40 cells + the crawl
  python -m repro_torch.launch.dryrun --all --mesh 1x4 --jobs 6
  python -m repro_torch.launch.dryrun --list
Records go to ``--out`` (``build/dryrun_torch/``, a mesh's under
``<mesh>/``), one JSON a cell. The reference's ``--subprocess``
(isolation from XLA's compile cache) has no meaning here: nothing is
compiled.

Beside the dry run, the reckoners of a run's bound that ``chip_smoke.py``
reports (``bound``, ``gat_cost``, ``recsys_cost``, ``lm_prefill_flops``,
``lm_weight_bytes``, ``lm_kv_bytes``, ``moe_bounds``) and its batch cut
(``cut_batch``, by this dry run's reckoning) live here.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
import weakref
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import registry
from repro_torch.launch import specs
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32)
from repro_torch.sharding import spmd

ROUND = 512             # the caching allocator's rounding of a block
OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"


def _round(n: int) -> int:
    return 0 if n == 0 else -(-n // ROUND) * ROUND


def tensors(x):
    """The tensors of a cell's argument or result: nested dicts, lists,
    tuples, NamedTuples and modules (their parameters and buffers)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, torch.nn.Module):
        yield from x.parameters()
        yield from x.buffers()
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from tensors(v)


def storage_bytes(x) -> Dict[int, int]:
    """{storage id: its rounded bytes} over the tensors of ``x``."""
    out = {}
    for t in tensors(x):
        st = t.untyped_storage()
        out[st._cdata] = _round(st.nbytes())
    return out


# the card's caching allocator (PyTorch's CUDACachingAllocator, default
# settings): blocks of up to SMALL_SIZE bytes come from segments of
# SMALL_BUFFER; larger ones below MIN_LARGE_ALLOC from segments of
# LARGE_BUFFER; the rest from a segment of their size rounded up to
# ROUND_LARGE
SMALL_SIZE, SMALL_BUFFER = 1 << 20, 2 << 20
MIN_LARGE_ALLOC, LARGE_BUFFER, ROUND_LARGE = 10 << 20, 20 << 20, 2 << 20


class CachingAllocator:
    """The card's caching allocator replayed on a cell's allocations, to
    reckon the segments it must hold, which the allocated bytes alone
    understate: each request rounded to 512 bytes takes the smallest free
    block of its pool (small: at most 1 MiB) that holds it, the lowest
    address first among equals, and splits off the rest when that is at
    least 512 bytes (small pool) or more than 1 MiB (large); with none, a
    new segment (``segment_size``); a freed block merges with free
    neighbours of its segment, and segments stay cached. The card frees
    its cached, wholly free segments only when a new one does not fit, so
    a step fits when the segments that hold a live block fit at every
    moment: ``needed`` is the largest sum of them. ``reserved_peak`` is
    the largest sum of all segments, cached ones included, which is what
    ``torch.cuda.max_memory_reserved`` reads on a card with room."""

    def __init__(self):
        self.pools = {True: [], False: []}     # small? -> sorted free blocks
        self.blocks: Dict[int, tuple] = {}     # key -> (seg, addr, size)
        self.segments: Dict[int, list] = {}    # seg -> [size, small, blocks]
        self.seg_free: Dict[int, set] = {}     # seg -> its free blocks
        self.reserved = self.in_use = self.needed = self.reserved_peak = 0

    @staticmethod
    def segment_size(size: int) -> int:
        if size <= SMALL_SIZE:
            return SMALL_BUFFER
        if size < MIN_LARGE_ALLOC:
            return LARGE_BUFFER
        return -(-size // ROUND_LARGE) * ROUND_LARGE

    def _put(self, blk, small):
        bisect.insort(self.pools[small], blk)
        self.seg_free[blk[2]].add(blk)

    def alloc(self, key: int, nbytes: int) -> None:
        if nbytes == 0:
            return
        size = _round(nbytes)
        small = size <= SMALL_SIZE
        pool = self.pools[small]
        i = bisect.bisect_left(pool, (size, -1, -1))
        if i < len(pool):
            blk = pool.pop(i)
            self.seg_free[blk[2]].discard(blk)
            bsize, addr, seg = blk
        else:
            seg, addr, bsize = len(self.segments), 0, self.segment_size(size)
            self.segments[seg] = [bsize, small, 0]
            self.seg_free[seg] = set()
            self.reserved += bsize
            self.reserved_peak = max(self.reserved_peak, self.reserved)
        rest = bsize - size
        if (rest >= ROUND) if small else (rest > SMALL_SIZE):
            self._put((rest, addr + size, seg), small)
        else:
            size = bsize
        sg = self.segments[seg]
        if sg[2] == 0:
            self.in_use += sg[0]
            self.needed = max(self.needed, self.in_use)
        sg[2] += 1
        self.blocks[key] = (seg, addr, size)

    def free(self, key: int) -> None:
        if key not in self.blocks:      # a storage of 0 bytes took none
            return
        seg, addr, size = self.blocks.pop(key)
        sg = self.segments[seg]
        for blk in [b for b in self.seg_free[seg]
                    if b[1] + b[0] == addr or addr + size == b[1]]:
            self.seg_free[seg].discard(blk)
            self.pools[sg[1]].remove(blk)
            addr, size = min(addr, blk[1]), size + blk[0]
        self._put((size, addr, seg), sg[1])
        sg[2] -= 1
        if sg[2] == 0:
            self.in_use -= sg[0]


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages ops make while the mode is on: ``cur``
    (alive now) and ``peak``; ``traffic`` adds every op's operand and
    result bytes (view ops move none); ``devices`` the device types of
    the results (``meta`` alone when nothing was allocated; ``lift_fresh``
    is passed over: it hands on a host constant that already exists, as
    ``torch.tensor`` of a Python number makes, before ``.to("meta")``).
    Each allocation and free also goes to ``pool``, a
    ``CachingAllocator``."""

    def __init__(self, pool: CachingAllocator):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.cur = self.peak = self.traffic = self.ops = 0
        self.devices = set()
        self.pool = pool

    def _free(self, key):
        self.cur -= self.live.pop(key)
        self.pool.free(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.traffic += registry.nbytes(*ins, *outs)
        # a view or an in-place result lies on an input's storage
        seen = {t.untyped_storage()._cdata for t in ins}
        if func is not torch.ops.aten.lift_fresh.default:
            self.devices.update(t.device.type for t in outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live or key in seen:
                continue
            nb = _round(st.nbytes())
            self.live[key] = nb
            self.cur += nb
            self.peak = max(self.peak, self.cur)
            self.pool.alloc(key, st.nbytes())
            weakref.finalize(st, self._free, key)
        return out


def crawl_temporaries(cfg, n_shards: int,
                      n_local: Optional[int] = None) -> Dict[str, int]:
    """The crawl step's transient bytes on a process holding ``n_local``
    of the ``n_shards`` shards (all of them by default), from
    ``CrawlConfig``'s buffer sizes: an insert's new frontier cells (url,
    priority, valid and their f32 scores), the pops' outputs, the fetched
    pages' outlinks (url, score, source, mask; copied once by extract),
    and the exchange's staging and its transposed buckets."""
    n_local = n_shards if n_local is None else n_local
    R, C = cfg.n_slots * n_local // n_shards, cfg.frontier_capacity
    k_row = max(1, cfg.fetch_batch // (cfg.n_slots // n_shards))
    pages = R * k_row
    links = pages * cfg.outlinks_per_page
    S = cfg.dispatch_capacity
    return {"frontier_insert": R * C * (8 + 4 + 1 + 4),
            "pops": pages * (8 + 4 + 1 + 8 + 4),
            "outlinks": 2 * links * (8 + 4 + 4 + 1),
            "exchange": 2 * n_local * S * (8 + 4 + 4)}


def crawl_collectives(cfg, n_shards: int, n_local: int) -> dict:
    """The collectives of a dispatch step of a crawl group, from its
    buffers: the exchange's one all-to-all of the int64 lanes (url,
    predicted domain, shipped flag, and a stateful ordering's value bits)
    of this process's buckets, (n_local, n_shards, capacity, lanes);
    none on one process."""
    if n_shards == n_local:
        return {}
    from repro_torch.ordering import get_ordering
    cap = max(8, -(-cfg.dispatch_capacity // n_shards) * 2)
    lanes = 4 if get_ordering(cfg.ordering).stateful else 3
    return {"all-to-all": {"count": 1,
                           "bytes": n_local * n_shards * cap * lanes * 8}}


def _peak_flops(meta: dict) -> float:
    return PEAK_FLOPS_BF16 if meta.get("dtype") == "bfloat16" \
        else PEAK_FLOPS_F32


MB_WALKED = (2, 3)      # microbatches walked for a train step of more


def trace(cell: specs.Cell) -> dict:
    """Run the cell's step on meta: {args, out, peak_new, traffic, ops,
    torch_flops, devices, kernels, pool} (bytes, FLOP; ``devices`` those
    of the arguments and of every op's results; ``kernels`` the meta
    routes' {name: {calls, flops, bytes}}; ``pool`` the
    ``CachingAllocator`` that took the arguments, then the step)."""
    arg = storage_bytes(cell.args)
    pool = CachingAllocator()
    for t in tensors(cell.args):
        st = t.untyped_storage()
        if st._cdata not in pool.blocks:
            pool.alloc(st._cdata, st.nbytes())
    raw = {"args": sum(arg.values()), "out": 0, "peak_new": 0,
           "traffic": 0, "ops": 0, "torch_flops": 0, "pool": pool,
           "devices": {t.device.type for t in tensors(cell.args)}}
    spmd.reset_collectives()
    with registry.meta_costs() as kern:
        if cell.fn is not None:
            fc, lb = FlopCounterMode(display=False), LiveBytes(pool)
            with fc, lb:
                res = cell.fn(*cell.args)
            raw.update(out=sum(v for k, v in storage_bytes(res).items()
                               if k not in arg),
                       peak_new=lb.peak, traffic=lb.traffic, ops=lb.ops,
                       torch_flops=fc.get_total_flops(),
                       devices=raw["devices"] | lb.devices)
            del res
    raw["kernels"] = {k: dict(v) for k, v in kern.items()}
    raw["collectives"] = spmd.collectives()
    return raw


def _extrapolate(r2: dict, r3: dict, mb: int) -> dict:
    """A step of ``mb`` microbatches from walks of 2 and 3 of the same
    size: every microbatch after the first makes the same ops and the
    same allocations (the accumulators live across them), so the work is
    linear in the count and the peak is the walk's."""
    def ext(a, b):
        return a + (mb - 2) * (b - a)
    kern = {}
    for name in set(r2["kernels"]) | set(r3["kernels"]):
        a = r2["kernels"].get(name, {"calls": 0, "flops": 0, "bytes": 0})
        b = r3["kernels"].get(name, {"calls": 0, "flops": 0, "bytes": 0})
        kern[name] = {k: ext(a[k], b[k]) for k in a}
    coll = {}
    for kind in set(r2["collectives"]) | set(r3["collectives"]):
        a = r2["collectives"].get(kind, {"count": 0, "bytes": 0})
        b = r3["collectives"].get(kind, {"count": 0, "bytes": 0})
        coll[kind] = {k: ext(a[k], b[k]) for k in a}
    return {**r3, "kernels": kern, "collectives": coll,
            "devices": r2["devices"] | r3["devices"],
            **{k: ext(r2[k], r3[k]) for k in ("traffic", "ops",
                                              "torch_flops")}}


def reckon(cell: specs.Cell, **rebuild) -> dict:
    """The record's memory and cost fields for a cell. A train step of
    more than 3 microbatches is walked at 2 and 3 (``rebuild`` rebuilds
    the cell with them) and extrapolated; the crawl cell's temporaries are
    ``crawl_temporaries``."""
    t0 = time.time()
    mb = cell.meta.get("microbatches", 1)
    extra = {}
    if mb > MB_WALKED[-1]:
        per = cell.meta["batch"] // mb
        args = sum(storage_bytes(cell.args).values())
        walks = [trace(specs.build_cell(**{**rebuild, "batch": n * per,
                                           "microbatches": n}))
                 for n in MB_WALKED]
        raw = _extrapolate(*walks, mb)
        raw["args"] = args                  # the whole batch's tokens
        extra["microbatches_walked"] = list(MB_WALKED)
    else:
        raw = trace(cell)
    if cell.fn is None:
        temps = crawl_temporaries(specs.CrawlConfig(**cell.meta["config"]),
                                  cell.meta["n_shards"],
                                  cell.meta.get("n_local"))
        raw["peak_new"] = sum(temps.values())
        for i, nb in enumerate(temps.values()):
            raw["pool"].alloc(-1 - i, nb)
        extra.update(crawl_temporaries=temps, reckoning=(
            "state on meta exactly; the step reads the host, so its "
            "temporaries are reckoned from CrawlConfig's buffer sizes"))
    if "mesh" in cell.meta:
        coll = dict(sorted(raw["collectives"].items()))
        if cell.fn is None:
            m = cell.meta
            coll = crawl_collectives(specs.CrawlConfig(**m["config"]),
                                     m["n_shards"], m["n_local"])
            extra["collectives_reckoning"] = (
                "a dispatch step's exchange, from its buffers (the step "
                "is not traced)")
        extra.update(collectives=coll, collective_bytes=sum(
            c["bytes"] for c in coll.values()))
    kflops = sum(e["flops"] for e in raw["kernels"].values())
    kbytes = sum(e["bytes"] for e in raw["kernels"].values())
    flops = raw["torch_flops"] + kflops
    total = raw["args"] + raw["peak_new"]
    needed = raw["pool"].needed
    min_bytes = raw["args"] + raw["out"]
    t_b = 1e3 * min_bytes / HBM_BW
    t_f = 1e3 * flops / _peak_flops(cell.meta)
    return {"memory": {"argument_size_in_bytes": raw["args"],
                       "output_size_in_bytes": raw["out"],
                       "temp_size_in_bytes": max(0, raw["peak_new"]
                                                 - raw["out"]),
                       "total_per_device": total,
                       "reserved_needed": needed,
                       "reserved_peak": raw["pool"].reserved_peak},
            "cost": {"flops": flops, "flops_torch": raw["torch_flops"],
                     "flops_kernels": kflops, "kernels": raw["kernels"]},
            "hbm_bytes_est": raw["traffic"] + kbytes,
            "min_bytes": min_bytes, "bound_ms": max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "ops_traced": raw["ops"], "devices": sorted(raw["devices"]),
            "time_trace_s": time.time() - t0,
            "fits": needed <= HBM_BYTES, **extra}


def cut_batch(arch: str, shape: str, B: int, budget: int = HBM_BYTES,
              variant: str = "baseline", **kw):
    """Halve a cell's batch B while the segments the card's allocator must
    hold for it, reckoned by the dry run (``run_cell`` on meta,
    ``reserved_needed``), exceed ``budget`` bytes: (the batch, 0 when not
    even 1 fits, and each step's {batch, reckoned_bytes}). A batch whose
    arguments alone exceed the budget is not traced (its
    ``reckoned_bytes`` are the arguments')."""
    steps = []
    while B >= 1:
        cell = specs.build_cell(arch, shape, variant=variant,
                                **{**kw, "batch": B})
        need = sum(storage_bytes(cell.args).values())
        del cell
        if need <= budget:
            need = run_cell(arch, shape, variant=variant, search=False,
                            **{**kw, "batch": B})[
                "memory"]["reserved_needed"]
        steps.append({"batch": B, "reckoned_bytes": need})
        if need <= budget:
            return B, steps
        B //= 2
    return 0, steps


MESHES = {"single": {"data": 16, "model": 16},
          "multi": (("pod", 2), ("data", 16), ("model", 16))}


def mesh_shape(name: str):
    """A ``--mesh`` value as a mesh shape: ``single``, ``multi`` or
    ``<dp>x<tp>``."""
    if name in MESHES:
        return MESHES[name]
    dp, tp = (int(v) for v in name.split("x"))
    return {"data": dp, "model": tp}


def mesh_record(arch: str, shape: str, mesh: str, variant: str = "baseline",
                *, rank: int = 0, search: bool = True, **kw) -> dict:
    """The per-card record of a cell under the mesh named ``mesh``
    (``mesh_shape``): rank ``rank``'s program on meta under a
    ``spmd.MetaMesh`` (``build_cell(..., mesh=)``), its collectives
    counted; the one-card record at one device; a ``not ported`` record
    for a cell whose mesh program the port does not run."""
    from repro_torch.sharding import rules
    sizes = rules.mesh_sizes(mesh_shape(mesh))
    n = int(np.prod(list(sizes.values())))
    head = {"arch": arch, "shape": shape, "variant": variant, "mesh": mesh,
            "mesh_shape": sizes, "n_devices": n, "rank": rank}
    why = specs.mesh_program(arch, shape)
    if why:
        return {**head, "mesh_program": "not ported", "why": why,
                "roadmap": "item 19d"}
    if n == 1:
        return {**run_cell(arch, shape, variant=variant, search=search,
                           **kw), **head, "collectives": {},
                "collective_bytes": 0}
    meta_mesh = spmd.MetaMesh(mesh_shape(mesh), rank)
    rec = run_cell(arch, shape, variant=variant, search=False,
                   mesh=meta_mesh, **kw)
    rec.update(head, mesh_program="ported")
    if search and not rec["fits"]:
        B = rec["meta"].get("batch", rec["meta"].get("batch_nodes"))
        largest = None
        if B:
            largest = cut_batch(arch, shape, 1, variant=variant,
                                mesh=meta_mesh, **kw)[0]
        if largest:
            largest = cut_batch(arch, shape, B // 2, variant=variant,
                                mesh=meta_mesh, **kw)[0]
        rec["largest_batch_that_fits"] = largest
    return rec


def run_cell(arch: str, shape: str, out_dir: Optional[str] = None,
             variant: str = "baseline", *, search: bool = True,
             mesh=None, **kw) -> dict:
    """Reckon one cell on meta (``specs.build_cell(arch, shape, **kw)``)
    and return its record, written to ``out_dir`` when given. A cell that
    does not fit also gets ``largest_batch_that_fits`` unless ``search``
    is off: 0 when batch 1 does not fit (tried first: a train step that
    does not fit at 1 would otherwise be walked at every halving), else
    ``cut_batch`` from half its batch. ``mesh`` a ``--mesh`` name: the
    per-card record of process 0 (``mesh_record``), under
    ``<out_dir>/<mesh>/``; a ``spmd.MetaMesh``: that process's cell, as
    ``mesh_record`` reckons it."""
    if isinstance(mesh, str):
        rec = mesh_record(arch, shape, mesh, variant, search=search,
                          **kw)
        _write(rec, out_dir and Path(out_dir) / mesh, arch, shape, variant)
        return rec
    if mesh is not None:
        kw["mesh"] = mesh
    cell = specs.build_cell(arch, shape, variant=variant, **kw)
    rebuild = dict(arch=arch, shape_name=shape, variant=variant, **kw)
    rec = {"arch": arch, "shape": shape, "variant": variant,
           "n_devices": 1, "device": "meta", "meta": cell.meta,
           **reckon(cell, **rebuild)}
    del cell
    if mesh is not None:
        return rec
    if arch == "webparf":
        four = specs.build_cell(arch, shape, variant=variant,
                                **{**kw, "n_shards": 4})
        rec["n_shards_4"] = reckon(four)
    if search and not rec["fits"]:
        B = rec["meta"].get("batch", rec["meta"].get("batch_nodes"))
        largest = None
        if B:
            largest = cut_batch(arch, shape, 1, variant=variant, **kw)[0]
        if largest:
            largest = cut_batch(arch, shape, B // 2, variant=variant,
                                **kw)[0]
        rec["largest_batch_that_fits"] = largest
    _write(rec, out_dir, arch, shape, variant)
    return rec


def _write(rec: dict, out_dir, arch: str, shape: str, variant: str):
    if out_dir:
        p = Path(out_dir)
        p.mkdir(parents=True, exist_ok=True)
        suffix = "" if variant == "baseline" else f"@{variant}"
        (p / f"{arch}__{shape}{suffix}.json").write_text(
            json.dumps(rec, indent=1, default=str))


def summary(rec: dict) -> str:
    """One line: fits, peak and reserved GiB, FLOP, bound ms on this
    card (under a mesh: one card's, and its collective bytes)."""
    if rec.get("mesh_program") == "not ported":
        return (f"[{rec['mesh']}] {rec['arch']:20s} {rec['shape']:15s} "
                f"mesh program not ported: {rec['why']}")
    if "mesh" in rec:
        return (f"[{rec['mesh']}] " + _summary(rec)
                + f"  collectives {rec['collective_bytes']:.3e} B")
    return _summary(rec)


def _summary(rec: dict) -> str:
    mem = rec["memory"]["total_per_device"] / 2 ** 30
    res = rec["memory"]["reserved_needed"] / 2 ** 30
    line = (f"{rec['arch']:20s} {rec['shape']:15s} "
            f"{'fits' if rec['fits'] else 'DOES NOT FIT':12s} "
            f"peak {mem:9.2f} GiB (segments {res:9.2f})  "
            f"{rec['cost']['flops']:.3e} FLOP  "
            f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")
    if "largest_batch_that_fits" in rec:
        line += f"  largest batch that fits: {rec['largest_batch_that_fits']}"
    if "n_shards_4" in rec:
        line += (f"  [4 shards: peak "
                 f"{rec['n_shards_4']['memory']['total_per_device'] / 2**30:.2f}"
                 f" GiB]")
    return line


def main(argv=None) -> int:
    from repro_torch.configs import all_cells

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--crawler", action="store_true",
                    help="also reckon the WebParF crawl cell")
    ap.add_argument("--variant", default="baseline",
                    choices=("baseline", "opt"))
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells reckoned at once, a process each")
    ap.add_argument("--mesh", default=None,
                    help="single | multi | both | <dp>x<tp>, or several "
                         "joined by commas: each cell reckoned per card")
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.list:
        for a, s in cells:
            print(f"{a:22s} {s}")
        return 0
    todo = cells if args.all else [(args.arch, args.shape)]
    if args.crawler or args.all:
        todo = list(todo) + [("webparf", "crawl_step")]
    meshes = [None]
    if args.mesh:
        meshes = [m for name in args.mesh.split(",") for m in
                  (("single", "multi") if name == "both" else (name,))]
    jobs = [(arch, shape, m) for m in meshes for arch, shape in todo]
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")
                ) as pool:
            futs = [pool.submit(run_cell, arch, shape, args.out,
                                args.variant, mesh=m)
                    for arch, shape, m in jobs]
            for f in futs:
                print(summary(f.result()), flush=True)
        return 0
    for arch, shape, m in jobs:
        rec = run_cell(arch, shape, args.out, args.variant, mesh=m)
        print(summary(rec), flush=True)
    return 0


def bound(nbytes, flops):
    """The least time: bytes over 3.35 TB/s or FLOP over the f32 peak."""
    b = 1e3 * nbytes / HBM_BW
    f = 1e3 * flops / PEAK_FLOPS_F32
    return {"bytes": nbytes, "flop": flops, "bytes_ms": b, "flop_ms": f,
            "bound_ms": max(b, f),
            "bound_by": "bytes" if b >= f else "operations",
            "peaks": "3.35 TB/s; 67 TFLOP/s f32 on the CUDA cores (TF32 "
                     "off)"}


def gat_cost(cfg, N, E, F, C):
    """A GAT train step's bytes (each layer's input read, its projection
    and output written, the per-edge gathers and the segment sums'
    scatters, forward; the backward twice that) and FLOP (3x the
    forward's)."""
    dims_in = [F] + [cfg.d_hidden * cfg.n_heads] * (cfg.n_layers - 1)
    dims_out = [cfg.d_hidden] * (cfg.n_layers - 1) + [C]
    H, b, f = cfg.n_heads, 0, 0
    for fi, d in zip(dims_in, dims_out):
        b += 4 * (N * fi + fi * H * d + 2 * N * H * d    # x, w; h and out
                  + 4 * E * H + E * H * d                # gathers
                  + E * H + E * H * d)                   # scatters
        f += 2 * N * fi * H * d + 4 * N * H * d + 12 * E * H + 2 * E * H * d
    return bound(3 * b, 3 * f)


def is_table(key):
    return key in ("item", "category", "user", "wide") or \
        key.startswith("tables/")


def recsys_cost(cfg, kind, B, C=0, batch_bytes=0):
    """The bound of one call at batch B: bytes (the gathered rows, and for
    a train step their gradients scattered back; the dense weights read,
    twice in a train step; the batch; a train step adds the table
    gradients written once and one AdamW pass, p, g, m, v read and p, m,
    v written: 7 bytes a parameter byte) and FLOP (3x the forward's in a
    train step). ``C`` candidates for retrieval."""
    from repro_torch.models import recsys as R
    shapes = R.param_shapes(cfg)
    P = 4 * sum(int(np.prod(s)) for s, _ in shapes.values())
    tables = 4 * sum(int(np.prod(s)) for k, (s, _) in shapes.items()
                     if is_table(k))
    dense = P - tables
    d, k = cfg.embed_dim, cfg.kind
    if k == "bert4rec":
        L, H = cfg.seq_len, cfg.n_heads
        rows = B * L + (B * R.N_MASK + R.N_NEG if kind == "train" else 0)
        f = cfg.n_blocks * (24 * L * d * d + 4 * L * L * d) * B
        f += {"train": 2 * B * R.N_MASK * (R.N_NEG + 1) * d,
              "serve": 2 * B * cfg.tables["item"] * d,
              "retrieval": 2 * C * d}[kind]
        row_bytes = 4 * d * rows
        extra = 4 * cfg.tables["item"] * d if kind == "serve" else 0
    elif k == "dien":
        S, gd = cfg.seq_len, cfg.gru_dim
        rows = B * (2 * S + 3) + 2 * C
        row_bytes = 4 * d * rows
        dims = (d + 2 * d + gd,) + tuple(cfg.mlp_dims) + (1,)
        f = B * (S * (12 * d * gd + 18 * gd * gd) + 2 * S * gd
                 + 4 * d * gd + sum(2 * a * b for a, b in zip(dims, dims[1:])))
        f += 4 * C * d
        extra = 0
    else:
        e = cfg.embed_dim
        if k == "wide_deep":
            bag = sum(cfg.multi_hot.values())
            ids = len(cfg.tables) - len(cfg.multi_hot) + bag
            row_bytes = 4 * (B * (ids * e + R.N_WIDE_CROSS) + C * e)
            dims = (len(cfg.tables) * e,) + tuple(cfg.mlp_dims) + (1,)
        else:
            d0 = cfg.n_dense + cfg.n_sparse * e
            row_bytes = 4 * (B * cfg.n_sparse * e + C * e)
            dims = (d0,) + tuple(cfg.mlp_dims)
            dims_head = cfg.mlp_dims[-1] + d0
        f = B * sum(2 * a * b for a, b in zip(dims, dims[1:]))
        if k == "dcn_v2":
            f += B * (cfg.n_cross_layers * 2 * d0 * d0 + 2 * dims_head)
        f += 2 * C * e
        extra = 0
    if kind == "train":
        return bound(2 * row_bytes + 2 * dense + tables + 7 * P
                     + batch_bytes, 3 * f)
    return bound(row_bytes + dense + extra + batch_bytes, f)


def lm_prefill_flops(cfg, B, S, kept=None):
    """The operations of one prefill of B x S tokens: the projections,
    the causal attention, the MLPs (an MoE layer's routed experts over
    its E x C bucket slots, what the bucketed GEMMs compute, or, given
    ``kept``, over each MoE layer's kept assignments, what the function
    needs; its shared experts, dense residual and router over every token)
    and the head on the last position."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import n_prefix
    d, hd, T = cfg.d_model, cfg.head_dim, B * S
    per_layer = (2 * T * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                 + 4 * B * cfg.n_heads * hd * (S * (S + 1) // 2))
    dense = 6 * T * d * cfg.d_ff
    P = n_prefix(cfg)
    mlp = P * dense
    if cfg.moe is None:
        mlp += (cfg.n_layers - P) * dense
    else:
        m = cfg.moe
        C = L.moe_capacity(m, T)
        moe = (6 * T * d * m.n_shared * m.d_ff_expert
               + 2 * T * d * m.n_experts)
        if m.dense_residual:
            moe += 6 * T * d * (m.d_ff_dense or cfg.d_ff)
        slots = ([m.n_experts * C] * (cfg.n_layers - P) if kept is None
                 else kept)
        mlp += (cfg.n_layers - P) * moe + sum(6 * n * d * m.d_ff_expert
                                              for n in slots)
    return cfg.n_layers * per_layer + mlp + 2 * B * d * cfg.vocab_size


def lm_weight_bytes(model):
    """The bytes of the weights one forward reads: every parameter but an
    untied embedding table, of which it reads only the tokens' rows."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters()
               if name != "embed" or model.lm_head is None)


def lm_kv_bytes(cfg, B, length):
    """The bytes of k and v a decode step reads at cache length
    ``length``, over every layer."""
    return (2 * cfg.n_layers * B * cfg.n_kv_heads * length * cfg.head_dim
            * getattr(torch, cfg.dtype).itemsize)


def routed_experts(routes):
    """The distinct experts that kept assignments reach, per MoE call."""
    return [len(set(e[k].tolist())) for e, k in routes]


def moe_bounds(model, B, P, gen, prefill_routes, decode_routes):
    """The function's bound, from this run's routes: a prefill takes the
    larger of its operations (each MoE layer's routed experts over its
    kept assignments, T x K at most) over 989 TFLOP/s (bf16) and its bytes
    (every weight but the routed experts, the experts some kept
    assignment reaches, and the k/v it writes) over 3.35 TB/s; a decode
    token the bytes of the same weights over that step's experts and the
    k/v it reads, averaged over the run's decode steps. Beside it
    (``bucketed_*``) the bound of the bucketed design (ROADMAP P9): the
    expert GEMMs over E x C slots, every expert's weights for any
    token, the same bytes otherwise."""
    cfg, m = model.cfg, model.cfg.moe
    item = getattr(torch, cfg.dtype).itemsize
    per_expert = 3 * cfg.d_model * m.d_ff_expert * item
    wbytes = lm_weight_bytes(model)
    n_moe = len(prefill_routes)
    other = wbytes - n_moe * m.n_experts * per_expert
    kept = [int(k.sum()) for _, k in prefill_routes]
    flops = lm_prefill_flops(cfg, B, P, kept=kept)
    pre_bytes = (other + per_expert * sum(routed_experts(prefill_routes))
                 + lm_kv_bytes(cfg, B, P))
    dec_bytes = [other + per_expert * sum(routed_experts(r))
                 + lm_kv_bytes(cfg, B, P + i)
                 for i, r in enumerate(decode_routes, 1)]
    t_ops = 1e3 * flops / PEAK_FLOPS_BF16
    t_b = 1e3 * pre_bytes / HBM_BW
    b_flops = lm_prefill_flops(cfg, B, P)
    kv = sum(lm_kv_bytes(cfg, B, P + i) for i in range(1, gen)) / (gen - 1)
    b_ops = 1e3 * b_flops / PEAK_FLOPS_BF16
    b_w = 1e3 * (wbytes + lm_kv_bytes(cfg, B, P)) / HBM_BW
    return {"prefill_flops": flops, "prefill_bytes": pre_bytes,
            "prefill_kept_assignments_per_moe_layer": kept,
            "prefill_routed_experts_per_moe_layer":
                routed_experts(prefill_routes),
            "prefill_ops_bound_ms": t_ops, "prefill_bytes_bound_ms": t_b,
            "prefill_bound_ms": max(t_ops, t_b),
            "prefill_bound_by": "operations" if t_ops >= t_b else "bytes",
            "decode_routed_experts_mean": sum(
                sum(routed_experts(r)) for r in decode_routes)
                / len(decode_routes) / n_moe,
            "decode_bytes_mean": sum(dec_bytes) / len(dec_bytes),
            "decode_bound_ms": 1e3 * sum(dec_bytes) / len(dec_bytes)
                / HBM_BW,
            "decode_bound_by": "bytes",
            "bucketed_prefill_flops": b_flops, "weight_bytes": wbytes,
            "bucketed_prefill_ops_bound_ms": b_ops,
            "bucketed_prefill_bytes_bound_ms": b_w,
            "bucketed_prefill_bound_ms": max(b_ops, b_w),
            "bucketed_decode_kv_bytes_mean": kv,
            "bucketed_decode_bound_ms": 1e3 * (wbytes + kv)
                / HBM_BW}


if __name__ == "__main__":
    sys.exit(main())
