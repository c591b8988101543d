"""The plain PyTorch version of the ``bloom`` kernel.

Replays the TPU kernel's ordered tile walk (repro/kernels/bloom): tile t
probes the filter after tiles 0..t-1 inserted, and within a tile ``seen`` is
membership before the tile. Inserts go into ``bits`` in place. The hash is
kept here, free of the crawl core, as the TPU kernel keeps its own; it
equals ``webgraph.hash2`` bit for bit.
"""
from __future__ import annotations

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
    bits_log2 = bits.shape[1].bit_length() - 1
    M = urls.shape[1]
    seen = [probe_insert_arrays(bits, urls[:, t0:t0 + url_tile],
                                mask[:, t0:t0 + url_tile], k=k,
                                bits_log2=bits_log2)
            for t0 in range(0, M, url_tile)]
    return torch.cat(seen, dim=1)
