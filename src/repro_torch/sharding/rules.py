"""The mesh context of the models, on one card. Counterpart of
``repro/sharding/rules.py``, the part with a single-card meaning.

The reference's models read the active mesh (``activation_mesh``) for two
things: ``constrain`` pins an activation's layout on the mesh, and
``layers.moe_block`` routes each (data shard, model shard) block of tokens
on its own (``_moe_spmd``). On one card no tensor is split, so
``constrain`` is the identity; but the blocks' routing changes which
assignments drop, so ``activation_mesh`` takes a mesh SHAPE, axis names
and sizes with no devices, and the port's ``moe_block`` routes the same
groups (``layers._moe_grouped``).

A shape is a mapping ``{"data": 4, "model": 2}`` or a sequence of
``(name, size)`` pairs such as ``(("pod", 2), ("data", 2), ("model", 2))``,
in the reference mesh's axis order.

Not ported, because one card places nothing (``ROADMAP.md`` lists them):
the ``PartitionSpec`` rules ``lm_specs``, ``lm_param_spec``,
``recsys_specs``, ``recsys_param_spec``, ``gnn_specs`` and
``opt_state_specs`` (where each leaf lies on a mesh), ``drop_fsdp`` (the
gather-once layout of the parameters), ``fsdp_axis`` and the helpers
``_guard``, ``_divisible`` and ``_path_str`` they share.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

MeshShape = Union[Mapping[str, int], Sequence[Tuple[str, int]]]

_ACT: Dict[str, object] = {"mesh": None, "dp": None, "tp": None}


def mesh_sizes(mesh: MeshShape) -> Dict[str, int]:
    """A mesh shape as an ordered {axis name: size}."""
    pairs = mesh.items() if isinstance(mesh, Mapping) else mesh
    out = {}
    for name, size in pairs:
        if name in out or int(size) < 1:
            raise ValueError(f"mesh shape {mesh!r}: axis {name!r} repeated "
                             f"or of size < 1")
        out[str(name)] = int(size)
    return out


def dp_axes(mesh: MeshShape) -> Tuple[str, ...]:
    """All data-parallel axes (``pod`` included when present)."""
    return tuple(a for a in mesh_sizes(mesh) if a in ("pod", "data"))


def set_activation_mesh(mesh: Optional[MeshShape], tp: str = "model"):
    if mesh is None:
        _ACT.update(mesh=None, dp=None, tp=None)
    else:
        sizes = mesh_sizes(mesh)
        if tp not in sizes:
            raise ValueError(f"mesh shape {sizes} has no axis {tp!r}")
        _ACT.update(mesh=sizes, dp=dp_axes(sizes), tp=tp)


class activation_mesh:
    """``with activation_mesh({"data": 4, "model": 2}):`` makes the shape
    the models' active mesh; the previous one comes back on exit."""

    def __init__(self, mesh: Optional[MeshShape], tp: str = "model"):
        self.mesh, self.tp = mesh, tp

    def __enter__(self):
        self.prev = dict(_ACT)
        set_activation_mesh(self.mesh, self.tp)

    def __exit__(self, *a):
        _ACT.update(self.prev)


def active_groups() -> Optional[Tuple[int, int]]:
    """(data-parallel size, model size) of the active mesh, or None."""
    sizes = _ACT["mesh"]
    if sizes is None:
        return None
    dp = 1
    for a in _ACT["dp"]:
        dp *= sizes[a]
    return dp, sizes[_ACT["tp"]]


def constrain(x: torch.Tensor, *pattern) -> torch.Tensor:
    """The identity: on one card every tensor is whole. ``pattern`` is the
    reference's ("dp", "tp", None or an axis name per dimension)."""
    return x
