"""The ``opic_update`` wrapper: the OPIC cash scatter-add.

Dispatch is by device (``registry.resolve_impl``): a CUDA tensor launches
the hand-written kernel (``csrc/opic_update.cu``) or raises; a CPU tensor
takes the plain version (``ref.opic_ref``); a meta tensor is returned as
it is, with the kernel's work recorded for the dry run. There is no
fallback between them. The kernel and the plain version update the
cash IN PLACE and add each target's contributions in item order, so the
result depends neither on the device nor on ``tile``: the kernel sorts the
live items by target (stably) and walks each target's items in order,
ignoring the tile, which stays in the signature (and its 1..1024 check)
for parity with the plain version and the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.build import Kernel
from repro_torch.kernels.opic_update.ref import opic_ref

# opic_update_launch(cash, rows, contrib, mask, B, R, N, ld, tile, stream)
KERNEL = Kernel("opic_update", n_ptr=4, n_int=5)


def _check(cash, rows, contrib, mask, tile):
    if cash.dim() != 2 or rows.dim() != 2 or contrib.shape != rows.shape \
            or mask.shape != rows.shape or rows.shape[0] != cash.shape[0]:
        raise ValueError(f"opic_update: want cash (B, R) and rows/contrib/"
                         f"mask (B, N), got {tuple(cash.shape)}, "
                         f"{tuple(rows.shape)}, {tuple(contrib.shape)}, "
                         f"{tuple(mask.shape)}")
    if (cash.dtype, rows.dtype, contrib.dtype, mask.dtype) != (
            torch.float32, torch.int64, torch.float32, torch.bool):
        raise TypeError(f"opic_update: want float32/int64/float32/bool, got "
                        f"{cash.dtype}/{rows.dtype}/{contrib.dtype}/"
                        f"{mask.dtype}")
    if not (cash.device == rows.device == contrib.device == mask.device):
        raise ValueError("opic_update: tensors on different devices")
    if not 1 <= tile <= 1024:
        raise ValueError(f"opic_update: tile={tile} outside 1..1024")


def scatter_cash(cash: torch.Tensor, rows: torch.Tensor,
                 contrib: torch.Tensor, mask: torch.Tensor, *,
                 tile: int = 256) -> torch.Tensor:
    """cash (B, R) f32; rows (B, N) int64, contrib (B, N) f32, mask (B, N)
    bool. Adds every masked contribution at its row of ``cash`` IN PLACE
    and returns ``cash``. Rows in [-R, 0) wrap; other out-of-range rows
    drop. ``cash`` may be a view whose rows are strided; its last axis must
    be contiguous."""
    _check(cash, rows, contrib, mask, tile)
    B, N = rows.shape
    if N == 0 or B == 0:
        return cash
    tile = min(tile, N)
    impl = registry.resolve_impl(KERNEL.name, cash.device.type)
    with registry.launch_scope(KERNEL.name, impl):
        if impl == "ref":
            return opic_ref(cash, rows, contrib, mask, tile=tile)
        if impl == "meta":
            # every item live: one add each, its target read and written
            registry.record_meta(KERNEL.name, B * N,
                                 registry.nbytes(rows, contrib, mask)
                                 + 8 * min(B * N, cash.numel()))
            return cash
        if not (rows.is_contiguous() and contrib.is_contiguous()
                and mask.is_contiguous()) or cash.stride(1) != 1:
            raise ValueError("opic_update: rows/contrib/mask must be "
                             "contiguous and cash's rows contiguous")
        KERNEL.launch(cash.data_ptr(), rows.data_ptr(), contrib.data_ptr(),
                      mask.data_ptr(), B, cash.shape[1], N, cash.stride(0),
                      tile)
    return cash


def scatter_cash_cells(table: torch.Tensor, rows: Optional[torch.Tensor],
                       cols: torch.Tensor, contrib: torch.Tensor,
                       mask: torch.Tensor, *, tile: int = 256
                       ) -> torch.Tensor:
    """table (R, C) f32, updated IN PLACE and returned. Every masked
    contribution adds into its (row, col) CELL; out-of-range coordinates
    drop.

    With ``rows`` given (items of any shape, as cols/contrib/mask), the
    table is one lane of R*C cells with index R*C as the drop cell, the
    JAX package's form. With ``rows=None`` the items are ROW-ALIGNED, (R, M)
    with item (r, m) in row r, and each row is its own batch of C targets:
    the same sums in the same order (within a row the items keep their
    order, and no item reaches another row), R blocks instead of one."""
    R, C = table.shape
    cols = cols.to(torch.int64)
    if rows is None:
        ok = mask & (cols >= 0) & (cols < C)
        return scatter_cash(table, cols.contiguous(), contrib.contiguous(),
                            ok, tile=tile)
    r = rows.reshape(1, -1).to(torch.int64)
    c = cols.reshape(1, -1)
    ok = mask.reshape(1, -1) & (r >= 0) & (r < R) & (c >= 0) & (c < C)
    flat = torch.where(ok, r * C + c, torch.full_like(r, R * C))
    lane = table.view(1, R * C)
    scatter_cash(lane, flat, contrib.reshape(1, -1).contiguous(), ok,
                 tile=tile)
    return table
