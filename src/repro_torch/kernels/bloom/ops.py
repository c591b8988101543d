"""The ``bloom`` wrapper: the dispatcher's Bloom probe and insert.

Dispatch is by device: a CUDA tensor launches the hand-written kernel
(``csrc/bloom.cu``) or raises; a CPU tensor takes the plain version
(``ref.bloom_ref``). There is no fallback between the two. A URL count that
is not a multiple of the tile is handled in both: the last tile is short.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bloom.ref import bloom_ref
from repro_torch.kernels.build import Kernel

# bloom_launch(bits, urls, mask, seen, R, M, k, bits_log2, tile, stream)
KERNEL = Kernel("bloom", n_ptr=4, n_int=5)


def _check(bits, urls, mask, k, url_tile):
    if bits.dim() != 2 or urls.dim() != 2 or mask.shape != urls.shape \
            or urls.shape[0] != bits.shape[0]:
        raise ValueError(f"bloom: want bits (R, 2^b) and urls/mask (R, M), "
                         f"got {tuple(bits.shape)}, {tuple(urls.shape)}, "
                         f"{tuple(mask.shape)}")
    nbits = bits.shape[1]
    if nbits < 1 or nbits & (nbits - 1) or nbits > 1 << 31:
        raise ValueError(f"bloom: row width {nbits} is not a power of two "
                         f"up to 2^31")
    if (bits.dtype, urls.dtype, mask.dtype) != (torch.uint8, torch.int64,
                                                torch.bool):
        raise TypeError(f"bloom: want uint8/int64/bool, got "
                        f"{bits.dtype}/{urls.dtype}/{mask.dtype}")
    if not (bits.device == urls.device == mask.device):
        raise ValueError("bloom: tensors on different devices")
    if k < 1 or not 1 <= url_tile <= 1024:
        raise ValueError(f"bloom: k={k}, url_tile={url_tile} out of range")


def probe_insert(bits: torch.Tensor, urls: torch.Tensor, mask: torch.Tensor,
                 *, k: int, url_tile: int = 256) -> torch.Tensor:
    """bits uint8 (R, 2^b), urls int64 / mask bool (R, M). Probes and
    inserts tile by tile, updating ``bits`` IN PLACE; returns seen (R, M)."""
    M = urls.shape[1]
    if M == 0:
        return torch.zeros(urls.shape, dtype=torch.bool, device=urls.device)
    url_tile = min(url_tile, M)
    _check(bits, urls, mask, k, url_tile)
    if urls.device.type == "cpu":
        return bloom_ref(bits, urls, mask, k=k, url_tile=url_tile)
    if urls.device.type != "cuda":
        raise ValueError(f"bloom: no kernel for {urls.device}")
    if not (bits.is_contiguous() and urls.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("bloom: tensors must be contiguous")
    R = urls.shape[0]
    seen = torch.empty((R, M), dtype=torch.bool, device=urls.device)
    KERNEL.launch(bits.data_ptr(), urls.data_ptr(), mask.data_ptr(),
                  seen.data_ptr(), R, M, k, bits.shape[1].bit_length() - 1,
                  url_tile)
    return seen
