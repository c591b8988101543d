"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Each family (``frontier_select`` with ``select_harvest``, ``bloom`` with
``bloom_packed``, ``opic_update``, ``dedup_deposit`` with
``dedup_deposit_packed``, and the LM's ``flash_attention`` with
``flash_attention_tc``) has
``ops.py`` (the wrappers that dispatch by device and count launches) and
``ref.py`` (the plain versions).
``all_kernels()`` lists them for builds and launch counts; ``rowsum.py``
holds the fixed-order f32 row sum the value channel shares.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.kernels.build import Kernel, build_all


def all_kernels() -> Tuple[Kernel, ...]:
    from repro_torch.kernels.bloom.ops import KERNEL as BLOOM
    from repro_torch.kernels.bloom.ops import PACKED as BLOOM_PACKED
    from repro_torch.kernels.dedup_deposit.ops import KERNEL as DEPOSIT
    from repro_torch.kernels.dedup_deposit.ops import \
        PACKED as DEPOSIT_PACKED
    from repro_torch.kernels.flash_attention.ops import KERNEL as FLASH
    from repro_torch.kernels.flash_attention.ops import TC_KERNEL as FLASH_TC
    from repro_torch.kernels.frontier_select.ops import HARVEST
    from repro_torch.kernels.frontier_select.ops import KERNEL as SELECT
    from repro_torch.kernels.opic_update.ops import KERNEL as OPIC
    return (SELECT, HARVEST, BLOOM, DEPOSIT, OPIC, FLASH, BLOOM_PACKED,
            DEPOSIT_PACKED, FLASH_TC)


def reset_launches() -> None:
    for k in all_kernels():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in all_kernels()}


__all__ = ["Kernel", "all_kernels", "build_all", "launch_counts",
           "reset_launches"]
