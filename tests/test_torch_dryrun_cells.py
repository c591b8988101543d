"""The port's dry run on ``meta``, every cell, on the CPU.

- Every cell and the crawl cell reckon on ``meta``: no op of the build or
  the step makes a tensor off meta (the build watched by ``OffMeta``, the
  step by the dry run's own ``LiveBytes``, which records its results'
  devices). The LM cells are cut to 2 layers here (the first-k-dense
  prefix kept) and DIEN's recurrences to 10 steps, at their published
  widths and shapes, so the file stays fast; ``python -m
  repro_torch.launch.dryrun --all`` reckons them whole.
- Each kernel's meta route gives the shapes and dtypes of its CPU route,
  records its work, and counts no launch.
- The largest batch that fits, and a train step of many microbatches
  walked at 2 and 3 and extrapolated, against the whole walk.

``test_torch_dryrun.py`` holds the cells against the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro_torch.configs import all_cells, get_arch, get_reduced  # noqa: E402
from repro_torch.configs.base import scaled  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402

CELLS = all_cells() + [("webparf", "crawl_step")]


class OffMeta(TorchDispatchMode):
    """Records every op result that is not a meta tensor. ``lift_fresh``
    is passed over: it hands on a host tensor that already exists (a
    config constant from numpy, ``torch.from_numpy``), making no storage,
    before ``.to("meta")`` takes its shape."""

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is not torch.ops.aten.lift_fresh.default:
            self.bad += [(str(func), t.device) for t in tree_flatten(out)[0]
                         if isinstance(t, torch.Tensor)
                         and t.device.type != "meta"]
        return out


def shallow(arch):
    """The cell's config cut in depth only: an LM to 2 layers, DIEN's GRU
    and AUGRU to 10 steps of its 100 (each step is a dozen ops)."""
    cfg = get_arch(arch)[0]
    if cfg.family == "lm":
        return scaled(cfg, n_layers=2)
    if arch == "dien":
        return scaled(cfg, seq_len=10)
    return cfg


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_every_cell_reckons_on_meta(arch, shape):
    """No op of the build (``OffMeta``) or of the step (the record's
    ``devices``, from the dry run's own ``LiveBytes``) makes a tensor off
    meta."""
    with OffMeta() as mode:
        specs.build_cell(arch, shape, cfg=shallow(arch))
    assert mode.bad == []
    rec = dryrun.run_cell(arch, shape, cfg=shallow(arch), search=False)
    assert rec["devices"] == ["meta"]
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["total_per_device"] == mem["argument_size_in_bytes"] + \
        mem["output_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert rec["n_devices"] == 1 and rec["bound_ms"] > 0
    assert isinstance(rec["fits"], bool)
    if arch == "webparf":
        assert rec["crawl_temporaries"] and "reckoning" in rec
        four = rec["n_shards_4"]["memory"]["argument_size_in_bytes"]
        assert four > mem["argument_size_in_bytes"]    # 4 shards' buffers
    else:
        assert rec["cost"]["flops"] > 0 and rec["hbm_bytes_est"] > 0
        assert rec["ops_traced"] > 0


# ---- each kernel's meta route against its CPU route ----------------------

def _kernel_calls():
    from repro_torch.kernels.bloom import ops as BO
    from repro_torch.kernels.dedup_deposit import ops as DO
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.frontier_select import ops as SO
    from repro_torch.kernels.opic_update import ops as OO
    rng = np.random.default_rng(0)
    R, C, M, k = 4, 64, 24, 3

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    url = t(rng.integers(0, 2 ** 32, (R, C)))
    pri = t(rng.random((R, C)).astype(np.float32))
    valid = t(rng.random((R, C)) < 0.6)
    table = t(rng.random((R, C)).astype(np.float32))
    bits = t(np.zeros((R, 1 << 10), np.uint8))
    words = t(np.zeros((R, (1 << 10) // 32), np.int32))
    urls = t(rng.integers(0, 2 ** 32, (R, M)))
    mask = t(rng.random((R, M)) < 0.7)
    val = t(rng.random((R, M)).astype(np.float32))
    rows = t(rng.integers(0, C, (R, M)))
    q = t(rng.standard_normal((2, 4, 32, 16)).astype(np.float32))
    kv = t(rng.standard_normal((2, 2, 32, 16)).astype(np.float32))
    qb = t(rng.standard_normal((1, 2, 16, 64)).astype(np.float32))
    kb = t(rng.standard_normal((1, 1, 16, 64)).astype(np.float32))
    return {
        "frontier_select": (SO.select, (url, pri, valid), dict(k=k)),
        "select_harvest": (SO.select_harvest, (url, pri, valid, table),
                           dict(k=k)),
        "bloom": (BO.probe_insert, (bits, urls, mask), dict(k=4)),
        "bloom_packed": (BO.probe_insert_packed, (words, urls, mask),
                         dict(k=4)),
        "dedup_deposit": (DO.dedup_deposit,
                          (bits, urls, mask, val, url, valid, table),
                          dict(k=4)),
        "dedup_deposit_packed": (DO.dedup_deposit_packed,
                                 (words, urls, mask, val, url, valid, table),
                                 dict(k=4)),
        "opic_update": (OO.scatter_cash, (table, rows, val, mask), {}),
        "flash_attention": (FO.attention, (q, kv, kv.clone()),
                            dict(causal=True)),
        "flash_attention_tc": (
            FO.attention, (qb.to(torch.bfloat16), kb.to(torch.bfloat16),
                           kb.to(torch.bfloat16)), dict(causal=True)),
    }


@pytest.mark.parametrize("name", registry.FAMILIES)
def test_meta_route_matches_cpu_shapes(name):
    fn, args, kw = _kernel_calls()[name]
    want = fn(*[a.clone() for a in args], **kw)
    meta = [a.to("meta") for a in args]
    with registry.meta_costs() as costs:
        got = fn(*meta, **kw)
    want, got = tree_flatten(want)[0], tree_flatten(got)[0]
    assert [(tuple(x.shape), x.dtype) for x in got] == \
        [(tuple(x.shape), x.dtype) for x in want]
    assert all(x.device.type == "meta" for x in got)
    assert list(costs) == [name]
    assert costs[name]["calls"] == 1 and costs[name]["flops"] > 0 \
        and costs[name]["bytes"] > 0


def test_meta_route_is_not_a_launch():
    from repro_torch.kernels import launch_counts, reset_launches
    reset_launches()
    for name in registry.FAMILIES:
        fn, args, kw = _kernel_calls()[name]
        fn(*[a.to("meta") for a in args], **kw)
    assert not any(launch_counts().values())
    with pytest.raises(ValueError, match="no kernel for"):
        registry.resolve_impl("bloom", "xpu")
    with pytest.raises(KeyError):
        registry.resolve_impl("nope", "cpu")


def test_largest_batch_search_and_train_walks():
    """A cell that does not fit gets the largest batch that does; a train
    step of many microbatches is walked at 2 and 3 and extrapolated, and
    agrees with the whole walk."""
    cfg = scaled(get_reduced("qwen2-1.5b"), d_model=256, n_heads=4,
                 n_kv_heads=2, d_ff=512, vocab_size=1024)
    whole = dryrun.run_cell("qwen2-1.5b", "train_4k", cfg=cfg, batch=9,
                            seq_len=128, microbatches=3)
    assert whole["meta"]["microbatches"] == 3
    assert "microbatches_walked" not in whole
    walked = dryrun.run_cell("qwen2-1.5b", "train_4k", cfg=cfg, batch=12,
                             seq_len=128, microbatches=6)
    full = dryrun.trace(specs.build_cell("qwen2-1.5b", "train_4k", cfg=cfg,
                                         batch=12, seq_len=128,
                                         microbatches=6))
    assert walked["microbatches_walked"] == [2, 3]
    assert walked["cost"]["flops"] == full["torch_flops"] + sum(
        e["flops"] for e in full["kernels"].values())
    assert walked["memory"]["total_per_device"] == \
        full["args"] + full["peak_new"]
    big = dataclasses.replace(get_arch("qwen2-1.5b")[0])
    rec = dryrun.run_cell("qwen2-1.5b", "prefill_32k", cfg=scaled(
        big, n_layers=2), batch=512)
    assert not rec["fits"]
    b = rec["largest_batch_that_fits"]
    assert 1 <= b < 512
    assert dryrun.run_cell("qwen2-1.5b", "prefill_32k", cfg=scaled(
        big, n_layers=2), batch=b)["fits"]
    assert not dryrun.run_cell("qwen2-1.5b", "prefill_32k", cfg=scaled(
        big, n_layers=2), batch=2 * b, search=False)["fits"]


MiB = 1 << 20


@pytest.mark.parametrize("nbytes,segment", [
    (1, 2 * MiB), (MiB, 2 * MiB), (MiB + 1, 20 * MiB),
    (10 * MiB - 512, 20 * MiB), (10 * MiB, 10 * MiB),
    (11 * MiB + 1, 12 * MiB)])
def test_allocator_segment_sizes(nbytes, segment):
    """A request takes a segment of the card allocator's size for it: 2
    MiB for the small pool (at most 1 MiB), 20 MiB below 10 MiB, else its
    size rounded up to 2 MiB."""
    pool = dryrun.CachingAllocator()
    pool.alloc(1, nbytes)
    assert pool.reserved == pool.needed == pool.reserved_peak == segment


def test_allocator_splits_merges_and_fragments():
    """Freed blocks merge with their free neighbours and are reused best
    fit, without a new segment; a hole smaller than a request is passed
    over for a new segment, so the segments needed exceed the bytes
    allocated; a wholly free segment is not counted as needed."""
    pool = dryrun.CachingAllocator()
    for key in range(3):                       # 3 x 6 MiB in one 20 MiB
        pool.alloc(key, 6 * MiB)
    assert pool.reserved == 20 * MiB
    pool.free(0)
    pool.free(1)                               # merged: 12 MiB free
    pool.alloc(3, 11 * MiB)                    # fits the merged hole
    assert pool.reserved == 20 * MiB and pool.blocks[3][1] == 0
    pool.free(3)
    pool.alloc(4, 5 * MiB)                     # best fit: the 2 MiB tail
    pool.alloc(5, 13 * MiB)                    # is too small: 12 MiB free
    assert pool.blocks[4][1] == 0 and pool.reserved == 20 * MiB + 14 * MiB
    assert pool.needed == 34 * MiB > 24 * MiB  # allocated: 6 + 5 + 13
    for key in (2, 4, 5):
        pool.free(key)
    assert pool.in_use == 0 and pool.reserved == 34 * MiB
    pool.alloc(6, 600)                         # small pool: its own segment
    assert pool.needed == 34 * MiB and pool.in_use == 2 * MiB


def test_fits_by_the_segments_the_allocator_needs():
    """A cell fits when the allocator's segments fit, which are at least
    the allocated peak; the reckoning is the same on every call."""
    cfg = scaled(get_arch("deepseek-moe-16b")[0], n_layers=2)
    rec = dryrun.run_cell("deepseek-moe-16b", "prefill_32k", cfg=cfg,
                          batch=1, seq_len=2048, search=False)
    mem = rec["memory"]
    assert mem["reserved_peak"] >= mem["reserved_needed"] >= \
        mem["total_per_device"]
    assert rec["fits"] == (mem["reserved_needed"] <= dryrun.HBM_BYTES)
    again = dryrun.run_cell("deepseek-moe-16b", "prefill_32k", cfg=cfg,
                            batch=1, seq_len=2048, search=False)
    assert again["memory"] == mem


def test_launch_labels_name_each_call():
    """With the labels on (``REPRO_TRACE_KERNELS``, here through
    ``set_annotations``), each wrapper call runs under one
    ``kernel/<family>.<impl>`` range: on the CPU the plain versions,
    ``ref``; off, no range is made."""
    from torch.profiler import ProfilerActivity, profile
    calls = _kernel_calls()

    def ranges(on):
        registry.set_annotations(on)
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                for name in registry.FAMILIES:
                    fn, args, kw = calls[name]
                    fn(*[a.clone() for a in args], **kw)
        finally:
            registry.set_annotations(None)
        return sorted(e.name for e in prof.events()
                      if e.name.startswith("kernel/"))
    fams = [n if not n.startswith("flash") else "flash_attention"
            for n in registry.FAMILIES]
    assert ranges(True) == sorted(f"kernel/{n}.ref" for n in fams)
    assert ranges(False) == []
    assert not registry.annotations_enabled()
