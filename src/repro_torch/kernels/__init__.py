"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Each family (``frontier_select``, ``bloom``) has ``ops.py`` (the wrapper
that dispatches by device and counts launches) and ``ref.py`` (the plain
version). ``all_kernels()`` lists them for builds and launch counts.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.kernels.build import Kernel, build_all


def all_kernels() -> Tuple[Kernel, ...]:
    from repro_torch.kernels.bloom.ops import KERNEL as BLOOM
    from repro_torch.kernels.frontier_select.ops import KERNEL as SELECT
    return (SELECT, BLOOM)


def reset_launches() -> None:
    for k in all_kernels():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in all_kernels()}


__all__ = ["Kernel", "all_kernels", "build_all", "launch_counts",
           "reset_launches"]
