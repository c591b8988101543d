"""The ``frontier_select`` wrappers: the URL allocator's pop, and the pop
fused with the url-lane cash harvest (``select_harvest``).

Dispatch is by device (``registry.resolve_impl``): a CUDA tensor
launches the hand-written kernel (``csrc/frontier_select.cu``, which
exports both entry points) or raises; a CPU tensor takes the plain version
(``ref.select_ref``, ``ref.select_harvest_ref``); a meta tensor gets
outputs of the right shapes and dtypes, pops nothing and records the
kernel's work for the dry run. There is no fallback between them.

The kernel has a vector path (float4 priorities and 32-bit words of four
flags) and a scalar path (a cell per load); ``vector_path`` picks it from
the width and the tensors' addresses.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.build import Kernel
from repro_torch.kernels.frontier_select.ref import (select_harvest_ref,
                                                     select_ref)

# frontier_select_launch(url, pri, valid, sel_url, sel_pri, sel_mask,
#                        sel_idx, R, C, k, vec, stream)
KERNEL = Kernel("frontier_select", n_ptr=7, n_int=4)
# select_harvest_launch(url, pri, valid, table, sel_url, sel_pri, sel_mask,
#                       sel_idx, cash, R, C, k, ld_table, vec, stream)
HARVEST = Kernel("select_harvest", n_ptr=9, n_int=5,
                 source="frontier_select")


def vector_path(pri: torch.Tensor, valid: torch.Tensor) -> bool:
    """Whether the kernel reads these (contiguous) rows by float4s and
    32-bit flag words: C a multiple of 4, ``pri`` 16-byte and ``valid``
    4-byte aligned, so that every row starts aligned as well."""
    return (pri.shape[1] % 4 == 0 and pri.data_ptr() % 16 == 0
            and valid.data_ptr() % 4 == 0)


def _check(url, pri, valid, k):
    if url.dim() != 2 or pri.shape != url.shape or valid.shape != url.shape:
        raise ValueError(f"frontier_select: url/pri/valid must share one "
                         f"(R, C) shape, got {tuple(url.shape)}, "
                         f"{tuple(pri.shape)}, {tuple(valid.shape)}")
    if (url.dtype, pri.dtype, valid.dtype) != (torch.int64, torch.float32,
                                               torch.bool):
        raise TypeError(f"frontier_select: want int64/float32/bool, got "
                        f"{url.dtype}/{pri.dtype}/{valid.dtype}")
    if not (url.device == pri.device == valid.device):
        raise ValueError("frontier_select: tensors on different devices")
    if not 1 <= k <= url.shape[1]:
        raise ValueError(f"frontier_select: k={k} outside 1..{url.shape[1]}")


def select(url: torch.Tensor, pri: torch.Tensor, valid: torch.Tensor, *,
           k: int, return_idx: bool = False):
    """url int64, pri f32, valid bool: (R, C). Pops the k best cells of
    every row IN PLACE (``pri`` -> NEG, ``valid`` -> False at the popped
    cells) and returns (sel_url, sel_pri, sel_mask) (R, k), plus the popped
    cell indices (R, k) int64 with ``return_idx``."""
    _check(url, pri, valid, k)
    impl = registry.resolve_impl(KERNEL.name, url.device.type)
    with registry.launch_scope(KERNEL.name, impl):
        if impl == "ref":
            return select_ref(url, pri, valid, k=k, return_idx=return_idx)
        out = _outputs(url, k)
        if impl == "meta":
            registry.record_meta(KERNEL.name, *_pop_cost(pri, valid, k))
        else:
            _launch_select(url, pri, valid, k, out)
    return out if return_idx else out[:3]


def _outputs(url, k, harvest=False):
    """(sel_url, sel_pri, sel_mask, sel_idx[, cash]) (R, k), uninitialised
    on url's device."""
    R, dev = url.shape[0], url.device
    dts = (torch.int64, torch.float32, torch.bool, torch.int64) + (
        (torch.float32,) if harvest else ())
    return tuple(torch.empty((R, k), dtype=dt, device=dev) for dt in dts)


def _pop_cost(pri, valid, k, harvest=False):
    """(operations, bytes) of a pop: k rounds of a compare over each row's
    flags and priorities; every flag and priority read once, the popped
    cells' url, priority and flag read and rewritten (and their cash), the
    outputs written."""
    R, C = pri.shape
    per_pop = 8 + 2 * (4 + 1) + 8 + 4 + 1 + 8 + (12 if harvest else 0)
    return R * C * k, registry.nbytes(pri, valid) + R * k * per_pop


def _launch_select(url, pri, valid, k, out):
    if not (url.is_contiguous() and pri.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("frontier_select: tensors must be contiguous")
    R, C = url.shape
    KERNEL.launch(url.data_ptr(), pri.data_ptr(), valid.data_ptr(),
                  *(t.data_ptr() for t in out), R, C, k,
                  int(vector_path(pri, valid)))


def select_harvest(url: torch.Tensor, pri: torch.Tensor, valid: torch.Tensor,
                   table: torch.Tensor, *, k: int):
    """``select`` plus the url-lane harvest: table (R, C) f32 is the cash
    lane, cell-aligned with the rows (it may be a view whose rows are
    strided, e.g. ``order_state[:, 2:]``). Pops in place as ``select``
    does, reads each popped cell's cash and zeroes that cell of ``table``
    in place. Returns (sel_url, sel_pri, sel_mask, idx, cash), all (R, k)."""
    _check(url, pri, valid, k)
    if table.shape != url.shape or table.dtype != torch.float32 \
            or table.device != url.device:
        raise ValueError(f"select_harvest: want a float32 table of shape "
                         f"{tuple(url.shape)} on {url.device}, got "
                         f"{table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    impl = registry.resolve_impl(HARVEST.name, url.device.type)
    with registry.launch_scope(HARVEST.name, impl):
        if impl == "ref":
            return select_harvest_ref(url, pri, valid, table, k=k)
        out = _outputs(url, k, harvest=True)
        if impl == "meta":
            registry.record_meta(HARVEST.name,
                                 *_pop_cost(pri, valid, k, harvest=True))
            return out
        if not (url.is_contiguous() and pri.is_contiguous()
                and valid.is_contiguous()) or table.stride(1) != 1:
            raise ValueError("select_harvest: url/pri/valid must be "
                             "contiguous and the table's rows contiguous")
        R, C = url.shape
        HARVEST.launch(url.data_ptr(), pri.data_ptr(), valid.data_ptr(),
                       table.data_ptr(), *(t.data_ptr() for t in out),
                       R, C, k, table.stride(0),
                       int(vector_path(pri, valid)))
    return out
