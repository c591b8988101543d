"""The plain PyTorch version of the ``frontier_select`` kernel.

Replays the TPU kernel's semantics (repro/kernels/frontier_select): per row,
the k best cells by key (priority where valid, NEG elsewhere), ties to the
lower index — a stable descending sort. The k popped cells of each row are
written in place into ``pri``/``valid``, as the CUDA kernel does. Masked
lanes (nothing left to pop) return url 0 and the NEG key; their index is the
sort's next cell.
"""
from __future__ import annotations

import numpy as np
import torch

NEG = float(np.float32(-3e38))
NEG_HALF = float(np.float32(NEG) * np.float32(0.5))


def select_ref(url: torch.Tensor, pri: torch.Tensor, valid: torch.Tensor, *,
               k: int, return_idx: bool = False):
    R = url.shape[0]
    keys = torch.where(valid, pri, torch.full_like(pri, NEG))
    spri, order = torch.sort(keys, dim=1, descending=True, stable=True)
    sel_pri = spri[:, :k].contiguous()
    idx = order[:, :k].contiguous()
    mask = sel_pri > NEG_HALF
    sel_url = torch.where(mask, torch.gather(url, 1, idx),
                          torch.zeros_like(idx))
    rows = torch.arange(R, device=url.device)[:, None].expand(R, k)
    r, c = rows[mask], idx[mask]
    pri[r, c] = NEG
    valid[r, c] = False
    if return_idx:
        return sel_url, sel_pri, mask, idx
    return sel_url, sel_pri, mask


def select_harvest_ref(url: torch.Tensor, pri: torch.Tensor,
                       valid: torch.Tensor, table: torch.Tensor, *, k: int):
    """``select_ref`` fused with the url-lane harvest: each popped cell's
    cash is read into ``cash`` (R, k), 0 where masked, and the cell of
    ``table`` is zeroed in place. Returns (sel_url, sel_pri, sel_mask, idx,
    cash)."""
    sel_url, sel_pri, mask, idx = select_ref(url, pri, valid, k=k,
                                             return_idx=True)
    cash = torch.where(mask, torch.gather(table, 1, idx),
                       torch.zeros_like(sel_pri))
    rows = torch.arange(url.shape[0], device=url.device)[:, None]
    r, c = rows.expand_as(idx)[mask], idx[mask]
    table[r, c] = 0.0
    return sel_url, sel_pri, mask, idx, cash
