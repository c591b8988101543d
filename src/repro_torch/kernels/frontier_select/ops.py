"""The ``frontier_select`` wrapper: the URL allocator's pop.

Dispatch is by device: a CUDA tensor launches the hand-written kernel
(``csrc/frontier_select.cu``) or raises; a CPU tensor takes the plain
version (``ref.select_ref``). There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import Kernel
from repro_torch.kernels.frontier_select.ref import select_ref

# frontier_select_launch(url, pri, valid, sel_url, sel_pri, sel_mask,
#                        sel_idx, R, C, k, stream)
KERNEL = Kernel("frontier_select", n_ptr=7, n_int=3)


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
    if url.device.type == "cpu":
        return select_ref(url, pri, valid, k=k, return_idx=return_idx)
    if url.device.type != "cuda":
        raise ValueError(f"frontier_select: no kernel for {url.device}")
    if not (url.is_contiguous() and pri.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("frontier_select: tensors must be contiguous")
    R, C = url.shape
    sel_url = torch.empty((R, k), dtype=torch.int64, device=url.device)
    sel_pri = torch.empty((R, k), dtype=torch.float32, device=url.device)
    sel_mask = torch.empty((R, k), dtype=torch.bool, device=url.device)
    sel_idx = torch.empty((R, k), dtype=torch.int64, device=url.device)
    KERNEL.launch(url.data_ptr(), pri.data_ptr(), valid.data_ptr(),
                  sel_url.data_ptr(), sel_pri.data_ptr(), sel_mask.data_ptr(),
                  sel_idx.data_ptr(), R, C, k)
    if return_idx:
        return sel_url, sel_pri, sel_mask, sel_idx
    return sel_url, sel_pri, sel_mask
