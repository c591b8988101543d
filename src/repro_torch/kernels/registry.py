"""Which implementation a kernel launch runs, and its launch labels.
Counterpart of ``repro/kernels/registry.py``, the launch labels only.

The reference resolves each family's implementation through a table
("ref", "pallas", "interpret", "auto"). The port's table is the device of
the tensors each wrapper (``kernels/<family>/ops.py``) is given:

  "cuda" — the hand-written kernel (a CUDA tensor)
  "ref"  — the plain PyTorch version (a CPU tensor)
  "meta" — outputs of the right shapes and dtypes, no storage, and the
           kernel's operations and bytes recorded for the dry run
           (``launch/dryrun.py``; a ``meta`` tensor)

``resolve_impl(kernel, device_type)`` names it. With ``REPRO_TRACE_KERNELS``
set (or ``set_annotations(True)``) every launch runs under
``torch.profiler.record_function("kernel/<family>.<impl>")``, so a
profile labels each kernel family's region; off, no range is made.

Not ported: ``register``, ``resolve`` and ``dispatch`` (the reference's
table of callables, which the device switch replaces) and the
implementations "pallas", "interpret" and "auto" (``ROADMAP.md``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Tuple

import torch

IMPLS = ("cuda", "ref", "meta")
FAMILIES = ("frontier_select", "select_harvest", "bloom", "bloom_packed",
            "dedup_deposit", "dedup_deposit_packed", "opic_update",
            "flash_attention", "flash_attention_tc")
_IMPL_OF = {"cuda": "cuda", "cpu": "ref", "meta": "meta"}

_ANNOTATE: Optional[bool] = None       # None -> read REPRO_TRACE_KERNELS


def set_annotations(on: Optional[bool]) -> None:
    """Force the launch labels on or off (None -> the environment)."""
    global _ANNOTATE
    _ANNOTATE = on


def annotations_enabled() -> bool:
    if _ANNOTATE is not None:
        return _ANNOTATE
    return os.environ.get("REPRO_TRACE_KERNELS", "0") not in ("", "0")


def kernels() -> Tuple[str, ...]:
    return tuple(sorted(FAMILIES))


def available(kernel: str) -> Tuple[str, ...]:
    if kernel not in FAMILIES:
        raise KeyError(f"unknown kernel {kernel!r}; registered: {kernels()}")
    return tuple(sorted(IMPLS))


def resolve_impl(kernel: str, device_type: str) -> str:
    """The implementation ``kernel``'s wrapper runs for tensors on
    ``device_type``: "cuda", "ref" or "meta". Raises for an unknown kernel
    or a device no implementation takes."""
    available(kernel)
    if device_type not in _IMPL_OF:
        raise ValueError(f"{kernel}: no kernel for {device_type}")
    return _IMPL_OF[device_type]


def launch_scope(kernel: str, impl: str):
    """The context a launch runs in: a ``kernel/<family>.<impl>`` range
    when the labels are on, else nothing."""
    if annotations_enabled():
        return torch.profiler.record_function(f"kernel/{kernel}.{impl}")
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# The meta route's costs: ``FlopCounterMode`` does not see the ctypes
# kernels, so each wrapper's meta branch records its kernel's work here
# ---------------------------------------------------------------------------

_COLLECTORS: List[Dict[str, Dict[str, float]]] = []


def record_meta(kernel: str, flops: float, nbytes: float) -> None:
    """Count one meta launch of ``kernel``: the operations it does and the
    bytes it must move (each input read once, each output written once)."""
    for c in _COLLECTORS:
        e = c.setdefault(kernel, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        e["calls"] += 1
        e["flops"] += flops
        e["bytes"] += nbytes


@contextlib.contextmanager
def meta_costs():
    """Collect the meta calls made inside: yields {kernel: {calls, flops,
    bytes}}, filled as they happen."""
    c: Dict[str, Dict[str, float]] = {}
    _COLLECTORS.append(c)
    try:
        yield c
    finally:
        _COLLECTORS.remove(c)


def nbytes(*ts: torch.Tensor) -> int:
    """The bytes of tensors' elements (meta tensors included)."""
    return sum(t.numel() * t.element_size() for t in ts)
