"""The plain PyTorch versions of the ``dedup_deposit`` kernel, on a
byte-per-bit filter and on one packed in int32 words (``bloom/ref.py``).

Both replay the TPU kernel's ordered tile walk (repro/kernels/dedup_deposit,
either variant): per row, tile t of ``url_tile`` URLs probes the
Bloom filter after tiles 0..t-1 inserted (``seen`` is membership before
the tile, as in the ``bloom`` kernel), then each seen URL is matched
against the URLs still queued in its row (``f_url`` where ``f_valid``; the
first such cell wins), its value is added to that cell of ``table`` (item
order within a target), and the values of seen URLs with no queued twin
add up to the row's refund: one ``tree_sum`` per tile, added tile after
tile. The filter and ``table`` are updated in place. The two differ only
in the filter's probe and insert.

The twin match sorts each row's queue once (stably, so equal URLs keep
column order) and looks every URL up by binary search, instead of forming
the (R, tile, C) comparison the TPU kernel formed in VMEM.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.bloom.ref import (probe_insert_arrays,
                                           probe_insert_words)
from repro_torch.kernels.opic_update.ref import add_in_item_order
from repro_torch.kernels.rowsum import tree_sum

_ABSENT = 1 << 40            # above every uint32 URL: an invalid cell


def sorted_queue(f_url: torch.Tensor, f_valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's queued URLs in ascending order (invalid cells last) and
    the column each came from; equal URLs keep their column order."""
    key = torch.where(f_valid, f_url, torch.full_like(f_url, _ABSENT))
    return torch.sort(key, dim=1, stable=True)


def first_twin(urls: torch.Tensor, look: torch.Tensor,
               queue: Tuple[torch.Tensor, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For every item of (R, M) with ``look`` set, the first valid cell of
    its row that holds the same URL. Returns (hit (R, M), cell (R, M)
    int64, C where there is no hit)."""
    skey, perm = queue
    C = skey.shape[1]
    pos = torch.searchsorted(skey, urls.contiguous())
    at = torch.clamp(pos, max=C - 1)
    hit = look & (pos < C) & (torch.gather(skey, 1, at) == urls)
    cell = torch.where(hit, torch.gather(perm, 1, at),
                       torch.full_like(at, C))
    return hit, cell


def _walk(probe, filt, bits_log2, urls, mask, val, f_url, f_valid, table,
          k, url_tile):
    R, M = urls.shape
    queue = sorted_queue(f_url, f_valid)
    refund = torch.zeros((R,), dtype=torch.float32, device=urls.device)
    seen = []
    for t0 in range(0, M, url_tile):
        u = urls[:, t0:t0 + url_tile]
        v = val[:, t0:t0 + url_tile]
        s = probe(filt, u, mask[:, t0:t0 + url_tile], k=k,
                  bits_log2=bits_log2)
        hit, cell = first_twin(u, s, queue)
        add_in_item_order(table, cell, v, hit)
        refund = refund + tree_sum(torch.where(s & ~hit, v,
                                               torch.zeros_like(v)))
        seen.append(s)
    return torch.cat(seen, dim=1), refund


def dedup_deposit_ref(bits: torch.Tensor, urls: torch.Tensor,
                      mask: torch.Tensor, val: torch.Tensor,
                      f_url: torch.Tensor, f_valid: torch.Tensor,
                      table: torch.Tensor, *, k: int, url_tile: int = 256
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bits (R, 2^b) u8; urls/mask/val (R, M); f_url/f_valid/table (R, C).
    Returns (seen (R, M), refund (R,)); bits and table in place."""
    return _walk(probe_insert_arrays, bits, bits.shape[1].bit_length() - 1,
                 urls, mask, val, f_url, f_valid, table, k, url_tile)


def dedup_deposit_packed_ref(words: torch.Tensor, urls: torch.Tensor,
                             mask: torch.Tensor, val: torch.Tensor,
                             f_url: torch.Tensor, f_valid: torch.Tensor,
                             table: torch.Tensor, *, k: int,
                             url_tile: int = 256
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dedup_deposit_ref`` on (R, 2^b / 32) int32 words, in place."""
    return _walk(probe_insert_words, words,
                 (32 * words.shape[1]).bit_length() - 1, urls, mask, val,
                 f_url, f_valid, table, k, url_tile)
