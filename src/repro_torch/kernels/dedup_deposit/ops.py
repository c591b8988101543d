"""The ``dedup_deposit`` wrappers: the fused dispatch's Bloom dedup, queued
twin match and cash deposit, on a byte-per-bit filter (``dedup_deposit``)
and on a filter packed in int32 words (``dedup_deposit_packed``; see
``bloom/ref.py`` for the layout). ``dedup_deposit(..., packed=True)`` is the
reference's ``pallas_packed`` entry: it packs the byte-per-bit filter, runs
the packed kernel, and unpacks the words back into the bytes.

Dispatch is by device (``registry.resolve_impl``): a CUDA tensor launches
the hand-written kernel (``csrc/dedup_deposit.cu``, which exports both
entry points) or raises; a CPU tensor takes the plain version
(``ref.dedup_deposit_ref``, ``ref.dedup_deposit_packed_ref``); a meta
tensor gets the outputs' shapes and dtypes, updates nothing and records
the kernel's work for the dry run. There is no fallback between them.
A URL count that is not a multiple of the tile is handled in both: the last
tile is short.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.bloom.ref import pack_bits, unpack_bits
from repro_torch.kernels import registry
from repro_torch.kernels.build import Kernel
from repro_torch.kernels.dedup_deposit.ref import (dedup_deposit_packed_ref,
                                                   dedup_deposit_ref)

# dedup_deposit_launch(bits, urls, mask, val, f_url, f_valid, table, seen,
#                      refund, R, M, C, k, bits_log2, tile, ld_table, stream)
KERNEL = Kernel("dedup_deposit", n_ptr=9, n_int=7)
# dedup_deposit_packed_launch(words, ...): the same arguments
PACKED = Kernel("dedup_deposit_packed", n_ptr=9, n_int=7,
                source="dedup_deposit")


def _check(filt, urls, mask, val, f_url, f_valid, table, k, url_tile, *,
           packed):
    R, M = urls.shape
    if filt.dim() != 2 or filt.shape[0] != R or mask.shape != urls.shape \
            or val.shape != urls.shape or f_url.dim() != 2 \
            or f_url.shape[0] != R or f_valid.shape != f_url.shape \
            or table.shape != f_url.shape:
        raise ValueError(
            f"dedup_deposit: want a filter (R, W), urls/mask/val (R, M) and "
            f"f_url/f_valid/table (R, C), got {tuple(filt.shape)}, "
            f"{tuple(urls.shape)}, {tuple(mask.shape)}, {tuple(val.shape)}, "
            f"{tuple(f_url.shape)}, {tuple(f_valid.shape)}, "
            f"{tuple(table.shape)}")
    nbits = filt.shape[1] * (32 if packed else 1)
    if nbits < (32 if packed else 1) or nbits & (nbits - 1) \
            or nbits > 1 << 31:
        raise ValueError(f"dedup_deposit: {nbits} bits a row is not a power "
                         f"of two up to 2^31")
    want = (torch.int32 if packed else torch.uint8, torch.int64, torch.bool,
            torch.float32, torch.int64, torch.bool, torch.float32)
    got = (filt.dtype, urls.dtype, mask.dtype, val.dtype, f_url.dtype,
           f_valid.dtype, table.dtype)
    if got != want:
        raise TypeError(f"dedup_deposit: want dtypes {want}, got {got}")
    if len({t.device for t in (filt, urls, mask, val, f_url, f_valid,
                               table)}) != 1:
        raise ValueError("dedup_deposit: tensors on different devices")
    if k < 1 or not 1 <= url_tile <= 1024:
        raise ValueError(f"dedup_deposit: k={k}, url_tile={url_tile} out of "
                         f"range")


def _run(filt, urls, mask, val, f_url, f_valid, table, k, url_tile, *,
         packed):
    R, M = urls.shape
    if M == 0:
        return (torch.zeros(urls.shape, dtype=torch.bool, device=urls.device),
                torch.zeros((R,), dtype=torch.float32, device=urls.device))
    url_tile = min(url_tile, M)
    _check(filt, urls, mask, val, f_url, f_valid, table, k, url_tile,
           packed=packed)
    kern = PACKED if packed else KERNEL
    impl = registry.resolve_impl(kern.name, urls.device.type)
    with registry.launch_scope(kern.name, impl):
        if impl == "ref":
            ref = dedup_deposit_packed_ref if packed else dedup_deposit_ref
            return ref(filt, urls, mask, val, f_url, f_valid, table, k=k,
                       url_tile=url_tile)
        seen = torch.empty((R, M), dtype=torch.bool, device=urls.device)
        refund = torch.empty((R,), dtype=torch.float32, device=urls.device)
        if impl == "meta":
            # every lane live: k probes and inserts each, every queue cell
            # read once, each URL's value deposited
            registry.record_meta(
                kern.name, 2 * k * R * M + R * f_url.shape[1],
                registry.nbytes(urls, mask, val, f_url, f_valid, seen,
                                refund)
                + 2 * k * R * M * (4 if packed else 1) + 8 * R * M)
            return seen, refund
        if not all(t.is_contiguous() for t in (filt, urls, mask, val, f_url,
                                               f_valid)) \
                or table.stride(1) != 1:
            raise ValueError("dedup_deposit: tensors must be contiguous "
                             "(the table's rows at least)")
        nbits = filt.shape[1] * (32 if packed else 1)
        kern.launch(
            filt.data_ptr(), urls.data_ptr(), mask.data_ptr(), val.data_ptr(),
            f_url.data_ptr(), f_valid.data_ptr(), table.data_ptr(),
            seen.data_ptr(), refund.data_ptr(), R, M, f_url.shape[1], k,
            nbits.bit_length() - 1, url_tile, table.stride(0))
    return seen, refund


def dedup_deposit(bits: torch.Tensor, urls: torch.Tensor, mask: torch.Tensor,
                  val: torch.Tensor, f_url: torch.Tensor,
                  f_valid: torch.Tensor, table: torch.Tensor, *, k: int,
                  url_tile: int = 256, packed: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bits uint8 (R, 2^b); urls int64, mask bool, val f32 (R, M); f_url
    int64, f_valid bool, table f32 (R, C) — the table may be a view whose
    rows are strided (``order_state[:, 2:]``).

    Probes and inserts the Bloom rows tile by tile, adds each seen URL's
    value to the first valid cell of its row's queue holding the same URL,
    and sums the values of seen URLs with no queued twin. ``bits`` and
    ``table`` are updated IN PLACE. Returns (seen (R, M), refund (R,)).

    ``packed``: the same, through the packed kernel: ``bits`` is packed
    into words, the words are probed and inserted, and unpacked back into
    ``bits``, a chunk of rows at a time."""
    if not packed:
        return _run(bits, urls, mask, val, f_url, f_valid, table, k,
                    url_tile, packed=False)
    if bits.dtype != torch.uint8 or bits.dim() != 2 or bits.shape[1] % 32:
        raise ValueError(f"dedup_deposit: packed=True wants uint8 bits "
                         f"(R, 2^b) with b >= 5, got {bits.dtype} "
                         f"{tuple(bits.shape)}")
    words = pack_bits(bits)
    out = _run(words, urls, mask, val, f_url, f_valid, table, k, url_tile,
               packed=True)
    unpack_bits(words, out=bits)
    return out


def dedup_deposit_packed(words: torch.Tensor, urls: torch.Tensor,
                         mask: torch.Tensor, val: torch.Tensor,
                         f_url: torch.Tensor, f_valid: torch.Tensor,
                         table: torch.Tensor, *, k: int, url_tile: int = 256
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dedup_deposit`` on int32 words (R, 2^b / 32) holding the filter's
    bits (``bloom.ref.pack_bits``); ``words`` and ``table`` are updated IN
    PLACE. Returns (seen (R, M), refund (R,))."""
    return _run(words, urls, mask, val, f_url, f_valid, table, k, url_tile,
                packed=True)
