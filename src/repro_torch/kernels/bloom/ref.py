"""The plain PyTorch versions of the ``bloom`` and ``bloom_packed``
kernels, and the packing between their two filter layouts.

Both replay the TPU kernels' ordered tile walk (repro/kernels/bloom): tile t
probes the filter after tiles 0..t-1 inserted, and within a tile ``seen`` is
membership before the tile. Inserts go into the filter in place. The hash is
kept here, free of the crawl core, as the TPU kernel keeps its own; it
equals ``webgraph.hash2`` bit for bit.

The packed layout holds bit ``32 j + p`` of a row in bit p of word j. The
words are ``torch.int32`` tensors carrying the uint32 bit pattern (torch's
uint32 has no shifts and no scatters on the CPU), so a word with bit 31 set
is negative: every shift right is masked with ``& 1``, and the packing
wraps its int64 sums to int32 explicitly.
"""
from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF


def _mix(x, salt: int):
    """webgraph._mix on int64 tensors or Python ints holding uint32."""
    x = (x & _M32) ^ ((salt * 0x9E3779B9 + 0x85EBCA6B) & _M32)
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & _M32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def _bit_indices(urls: torch.Tensor, k: int, bits_log2: int) -> torch.Tensor:
    """urls (..., M) int64 -> (..., M, k) bit positions via double hashing:
    hash2(u, b) = mix(u + mix(b, 7), 0) for b = 101 and 202. The sum stays
    below 2^37, so the mask gives the uint32-wrapped result."""
    u = urls.to(torch.int64)
    h1 = _mix((u + _mix(101, 7)) & _M32, 0)
    h2 = _mix((u + _mix(202, 7)) & _M32, 0) | 1
    i = torch.arange(k, dtype=torch.int64, device=urls.device)
    return (h1[..., None] + i * h2[..., None]) & ((1 << bits_log2) - 1)


def probe_insert_arrays(bits: torch.Tensor, urls: torch.Tensor,
                        mask: torch.Tensor, *, k: int,
                        bits_log2: int) -> torch.Tensor:
    """Whole-batch probe-then-insert on the raw bits, in place. Returns
    seen (R, M): membership BEFORE this batch, ANDed with ``mask``."""
    idx = _bit_indices(urls, k, bits_log2)                 # (R, M, k)
    rows = torch.arange(urls.shape[0], device=urls.device)[:, None, None]
    rows = rows.expand(idx.shape)
    seen = (bits[rows, idx] == 1).all(dim=-1) & mask
    ins = mask[..., None].expand(idx.shape)
    r, c = rows[ins], idx[ins]
    # scatter-max of 1: every duplicate position writes the same value
    bits[r, c] = bits[r, c].clamp_min(1)
    return seen


def bloom_ref(bits: torch.Tensor, urls: torch.Tensor, mask: torch.Tensor, *,
              k: int, url_tile: int = 256) -> torch.Tensor:
    return _tile_walk(probe_insert_arrays, bits, urls, mask, k, url_tile,
                      bits.shape[1].bit_length() - 1)


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same 32 bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _chunk_rows(row_bytes: int) -> int:
    """Rows per chunk for a temporary of ``row_bytes`` a row: about 1 GiB."""
    return max(1, (1 << 30) // row_bytes)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(R, 2^b) uint8 byte-per-bit -> (R, 2^b / 32) int32 words, a chunk of
    rows at a time (the int64 temporary stays near 1 GiB)."""
    R, n = bits.shape
    words = torch.empty((R, n // 32), dtype=torch.int32, device=bits.device)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    step = _chunk_rows(8 * n)
    for r0 in range(0, R, step):
        b = bits[r0:r0 + step].reshape(-1, n // 32, 32).to(torch.int64)
        words[r0:r0 + step] = _to_int32((b << shifts).sum(dim=-1))
    return words


def unpack_bits(words: torch.Tensor, out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """(R, W) int32 words -> (R, 32 W) uint8 byte-per-bit, written into
    ``out`` when given, a chunk of rows at a time."""
    R, W = words.shape
    if out is None:
        out = torch.empty((R, 32 * W), dtype=torch.uint8, device=words.device)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    step = _chunk_rows(4 * 32 * W)
    for r0 in range(0, R, step):
        w = words[r0:r0 + step, :, None]
        out[r0:r0 + step] = ((w >> shifts) & 1).to(torch.uint8).reshape(
            -1, 32 * W)
    return out


def probe_insert_words(words: torch.Tensor, urls: torch.Tensor,
                       mask: torch.Tensor, *, k: int,
                       bits_log2: int) -> torch.Tensor:
    """``probe_insert_arrays`` on int32 words, in place. Bits that several
    URLs set in one word are all kept: the distinct positions' powers of
    two are summed per word in int64 (a sum of distinct powers is their
    OR) and ORed into the word."""
    idx = _bit_indices(urls, k, bits_log2)                 # (R, M, k)
    R, W = words.shape
    rows = torch.arange(R, device=urls.device)[:, None, None].expand(
        idx.shape)
    got = words[rows, idx >> 5]
    seen = (((got >> (idx & 31).to(torch.int32)) & 1) == 1).all(dim=-1) \
        & mask
    pos = torch.unique((rows * (32 * W) + idx)[mask[..., None].expand(
        idx.shape)])
    word, inv = torch.unique(pos >> 5, return_inverse=True)
    add = torch.zeros(word.shape, dtype=torch.int64, device=urls.device)
    add.index_add_(0, inv, torch.ones_like(pos) << (pos & 31))
    flat = words.view(-1)
    flat[word] = flat[word] | _to_int32(add)
    return seen


def _tile_walk(fn, filt, urls, mask, k, url_tile, bits_log2):
    M = urls.shape[1]
    seen = [fn(filt, urls[:, t0:t0 + url_tile], mask[:, t0:t0 + url_tile],
               k=k, bits_log2=bits_log2) for t0 in range(0, M, url_tile)]
    return torch.cat(seen, dim=1)


def bloom_packed_ref(words: torch.Tensor, urls: torch.Tensor,
                     mask: torch.Tensor, *, k: int, url_tile: int = 256
                     ) -> torch.Tensor:
    """``bloom_ref`` on (R, 2^b / 32) int32 words, in place; returns seen."""
    return _tile_walk(probe_insert_words, words, urls, mask, k, url_tile,
                      (32 * words.shape[1]).bit_length() - 1)
