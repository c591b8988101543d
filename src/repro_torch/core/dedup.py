"""URL de-duplication — the dispatcher's filter stage (paper §IV.B.4).
Counterpart of ``repro/core/dedup.py``.

Two levels: batch-local EXACT dedup (stable sort + neighbour equality), and
a per-domain-row byte-per-bit BLOOM FILTER remembering everything ever
inserted into that row. Unlike the JAX module, the filter is updated IN
PLACE: at the full config it is 512 rows x 16 MiB, and a functional copy per
dispatch would dwarf the work.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.bloom.ops import probe_insert as _kernel_probe
from repro_torch.kernels.bloom.ref import (_bit_indices,  # noqa: F401
                                           probe_insert_arrays)

_BIG = 0xFFFFFFFF


class Bloom(NamedTuple):
    bits: torch.Tensor     # (R, 2^b) uint8 — one filter per domain row
    n_bits_log2: int


def init_bloom(n_rows: int, bits_log2: int, device) -> Bloom:
    return Bloom(torch.zeros((n_rows, 1 << bits_log2), dtype=torch.uint8,
                             device=device), bits_log2)


def probe_insert(b: Bloom, urls: torch.Tensor, mask: torch.Tensor, *,
                 k: int, url_tile: int = 256) -> Tuple[torch.Tensor, Bloom]:
    """urls/mask (R, M). Returns (seen (R, M), the filter), the filter
    updated in place by the ``bloom`` kernel (or its plain version on the
    CPU). URLs go in tiles of ``url_tile``; a tile probes after the earlier
    tiles inserted, and within a tile ``seen`` is membership before it."""
    seen = _kernel_probe(b.bits, urls, mask, k=k, url_tile=url_tile)
    return seen, b


def exact_dedup(urls: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Batch-local exact dedup along the trailing axis: keep the FIRST
    occurrence of each URL. Returns the filtered mask."""
    key = torch.where(mask, urls, torch.full_like(urls, _BIG))
    sorted_u, order = torch.sort(key, dim=-1, stable=True)
    first = torch.ones_like(sorted_u, dtype=torch.bool)
    first[..., 1:] = sorted_u[..., 1:] != sorted_u[..., :-1]
    keep_sorted = first & (sorted_u != _BIG)
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return keep & mask


def fp_rate(b: Bloom, n_inserted: torch.Tensor, k: int) -> torch.Tensor:
    """Analytic false-positive rate given inserts per row (f32)."""
    m = float(1 << b.n_bits_log2)
    return (1.0 - torch.exp(-k * n_inserted.to(torch.float32) / m)) ** k
