"""The ``bloom`` wrappers: the dispatcher's Bloom probe and insert, on
byte-per-bit rows (``probe_insert``) and on packed int32 words
(``probe_insert_packed``, see ``ref.py`` for the layout).

Dispatch is by device (``registry.resolve_impl``): a CUDA tensor launches
the hand-written kernel (``csrc/bloom.cu``, which exports both entry
points) or raises; a CPU tensor takes the plain version (``ref.bloom_ref``,
``ref.bloom_packed_ref``); a meta tensor gets ``seen``'s shape and dtype,
inserts nothing and records the kernel's work for the dry run. There is no
fallback between them. A URL count that is not a multiple of
the tile is handled in both: the last tile is short.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bloom.ref import bloom_packed_ref, bloom_ref
from repro_torch.kernels import registry
from repro_torch.kernels.build import Kernel

# bloom_launch(bits, urls, mask, seen, R, M, k, bits_log2, tile, stream)
KERNEL = Kernel("bloom", n_ptr=4, n_int=5)
# bloom_packed_launch(words, urls, mask, seen, R, M, k, bits_log2, tile,
#                     stream)
PACKED = Kernel("bloom_packed", n_ptr=4, n_int=5, source="bloom")


def _check(filt, urls, mask, k, url_tile, *, packed):
    if filt.dim() != 2 or urls.dim() != 2 or mask.shape != urls.shape \
            or urls.shape[0] != filt.shape[0]:
        raise ValueError(f"bloom: want a filter (R, W) and urls/mask "
                         f"(R, M), got {tuple(filt.shape)}, "
                         f"{tuple(urls.shape)}, {tuple(mask.shape)}")
    nbits = filt.shape[1] * (32 if packed else 1)
    if nbits < (32 if packed else 1) or nbits & (nbits - 1) \
            or nbits > 1 << 31:
        raise ValueError(f"bloom: {nbits} bits a row is not a power of two "
                         f"up to 2^31")
    want = (torch.int32 if packed else torch.uint8, torch.int64, torch.bool)
    if (filt.dtype, urls.dtype, mask.dtype) != want:
        raise TypeError(f"bloom: want {want}, got "
                        f"{(filt.dtype, urls.dtype, mask.dtype)}")
    if not (filt.device == urls.device == mask.device):
        raise ValueError("bloom: tensors on different devices")
    if k < 1 or not 1 <= url_tile <= 1024:
        raise ValueError(f"bloom: k={k}, url_tile={url_tile} out of range")


def _run(filt, urls, mask, k, url_tile, *, packed):
    M = urls.shape[1]
    if M == 0:
        return torch.zeros(urls.shape, dtype=torch.bool, device=urls.device)
    url_tile = min(url_tile, M)
    _check(filt, urls, mask, k, url_tile, packed=packed)
    kern = PACKED if packed else KERNEL
    impl = registry.resolve_impl(kern.name, urls.device.type)
    with registry.launch_scope(kern.name, impl):
        if impl == "ref":
            ref = bloom_packed_ref if packed else bloom_ref
            return ref(filt, urls, mask, k=k, url_tile=url_tile)
        R = urls.shape[0]
        seen = torch.empty((R, M), dtype=torch.bool, device=urls.device)
        if impl == "meta":
            # every lane live: k hashes and probes each, k bits inserted
            registry.record_meta(kern.name, 2 * k * R * M,
                                 registry.nbytes(urls, mask, seen)
                                 + 2 * k * R * M * (4 if packed else 1))
            return seen
        if not (filt.is_contiguous() and urls.is_contiguous()
                and mask.is_contiguous()):
            raise ValueError("bloom: tensors must be contiguous")
        nbits = filt.shape[1] * (32 if packed else 1)
        kern.launch(filt.data_ptr(), urls.data_ptr(), mask.data_ptr(),
                    seen.data_ptr(), R, M, k, nbits.bit_length() - 1,
                    url_tile)
    return seen


def probe_insert(bits: torch.Tensor, urls: torch.Tensor, mask: torch.Tensor,
                 *, k: int, url_tile: int = 256) -> torch.Tensor:
    """bits uint8 (R, 2^b), urls int64 / mask bool (R, M). Probes and
    inserts tile by tile, updating ``bits`` IN PLACE; returns seen (R, M)."""
    return _run(bits, urls, mask, k, url_tile, packed=False)


def probe_insert_packed(words: torch.Tensor, urls: torch.Tensor,
                        mask: torch.Tensor, *, k: int,
                        url_tile: int = 256) -> torch.Tensor:
    """``probe_insert`` on int32 words (R, 2^b / 32) holding the filter's
    bits (``ref.pack_bits``), updated IN PLACE; returns seen (R, M)."""
    return _run(words, urls, mask, k, url_tile, packed=True)
