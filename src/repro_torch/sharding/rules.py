"""Per-architecture placement rules for the train mesh, and the models'
mesh context. Counterpart of ``repro/sharding/rules.py``.

Mesh axes (``launch/mesh.make_host_mesh``): ("data", "model"), or
("pod", "data", "model") for a shape. The layout is the reference's:

  * the batch -> DP over ("pod", "data") (all data axes)
  * FSDP (parameters and optimizer state sharded) -> "data" only
  * TP (heads, FFN columns, vocab rows) -> "model"
  * EP (MoE experts) -> "model"

A spec is the reference's ``PartitionSpec`` as a tuple, one entry per
dimension (fewer entries leave the last dims whole): None, an axis name,
or a tuple of names. The rules match a leaf's path in the checkpoint form
(``layers/attn/wq``; a ``layers/*`` leaf is stacked on a leading layer
axis) and take a ``mesh`` that is a ``DeviceMesh`` (its dimension names
are the axis names) or a mesh SHAPE, axis names and sizes with no
devices: a mapping ``{"data": 4, "model": 2}`` or a sequence of
``(name, size)`` pairs such as ``(("pod", 2), ("data", 2), ("model", 2))``
in the mesh's axis order. ``NamedSharding`` pairs a mesh and a spec, as
the reference's does; ``placements`` turns it into DTensor placements.

The models read the active mesh (``activation_mesh``) for two things.
Under a mesh shape (one card) ``layers.moe_block`` routes each (data,
model) block of tokens as its own group (``layers._moe_grouped``) and
``constrain`` is the identity. Under a real ``DeviceMesh`` each process
computes on its own shard: ``layers`` and ``transformer`` place their
activations with explicit collectives over the mesh's groups
(``sharding.spmd``), ``moe_block`` is the reference's ``_moe_spmd``, and
``constrain`` redistributes a DTensor to its pattern (a plain local
tensor is already where the layer's collectives put it).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, \
    Union

import torch

MeshShape = Union[Mapping[str, int], Sequence[Tuple[str, int]]]
Spec = Tuple[Any, ...]

_ACT: Dict[str, object] = {"mesh": None, "dp": None, "tp": None,
                           "device_mesh": None}


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def mesh_sizes(mesh) -> Dict[str, int]:
    """A mesh (a ``DeviceMesh`` or a shape) as an ordered {axis: size}."""
    if _is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    pairs = mesh.items() if isinstance(mesh, Mapping) else mesh
    out = {}
    for name, size in pairs:
        if name in out or int(size) < 1:
            raise ValueError(f"mesh shape {mesh!r}: axis {name!r} repeated "
                             f"or of size < 1")
        out[str(name)] = int(size)
    return out


def dp_axes(mesh) -> Tuple[str, ...]:
    """All data-parallel axes (``pod`` included when present)."""
    return tuple(a for a in mesh_sizes(mesh) if a in ("pod", "data"))


# ---------------------------------------------------------------------------
# Activation mesh: models call ``constrain(x, "dp", None, "tp")`` at the
# reference's layer boundaries and read the mesh for the MoE groups.
# ---------------------------------------------------------------------------

def set_activation_mesh(mesh, tp: str = "model"):
    if mesh is None:
        _ACT.update(mesh=None, dp=None, tp=None, device_mesh=None)
        return
    sizes = mesh_sizes(mesh)
    if tp not in sizes:
        raise ValueError(f"mesh shape {sizes} has no axis {tp!r}")
    _ACT.update(mesh=sizes, dp=dp_axes(sizes), tp=tp,
                device_mesh=mesh if _is_device_mesh(mesh) else None)


class activation_mesh:
    """``with activation_mesh(mesh):`` makes ``mesh`` (a ``DeviceMesh`` or
    a shape) the models' active mesh; the previous one comes back on
    exit."""

    def __init__(self, mesh, tp: str = "model"):
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


def active_device_mesh():
    """The active ``DeviceMesh``, or None (no mesh, or a mesh shape)."""
    return _ACT["device_mesh"]


def constrain(x, *pattern):
    """pattern entries: "dp", "tp", None, or a concrete axis name, one a
    dimension. On a real mesh a DTensor is redistributed to the pattern,
    its dims that the axes do not divide left whole (``_guard``); a plain
    tensor, or any tensor under a mesh shape or no mesh, is returned as
    it is. The models' calls stand at the reference's places as markers:
    the train step computes on plain local tensors (``train.trainer``),
    so there they are the identity, and the placements they name are
    made by ``sharding.spmd``'s explicit collectives."""
    mesh = _ACT["device_mesh"]
    if mesh is None or not _is_dtensor(x):
        return x
    spec = tuple(_ACT[p] if p in ("dp", "tp") else p for p in pattern)
    return x.redistribute(x.device_mesh, placements(
        NamedSharding(x.device_mesh, _guard(spec, x.shape, mesh))))


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def fsdp_axis(mesh) -> str:
    return "data"


def _path_str(path) -> str:
    """A leaf's path joined with ``/``: the port's checkpoint key as it
    is, or a sequence of parts (numbers for list indices)."""
    if isinstance(path, str):
        return path
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _divisible(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    sizes = mesh_sizes(mesh)
    n = 1
    for a in _axes(axes):
        n *= sizes[a]
    return dim % n == 0


def _guard(spec: Spec, shape, mesh) -> Spec:
    """Drop any spec axis that doesn't divide the dimension (odd head
    counts etc.); a dropped axis leaves the dimension whole. One entry a
    dimension comes back."""
    spec = tuple(spec)
    fixed = []
    for dim, axes in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        fixed.append(axes if _divisible(dim, mesh, axes) else None)
    return tuple(fixed)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", leaf))


class NamedSharding(NamedTuple):
    """A mesh (``DeviceMesh`` or shape) and a spec: the reference's
    ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: Spec


_LM_RULES = [
    # (path regex, spec WITHOUT the stacked leading axis); the reference's
    # table: vocab-parallel embedding and head, column-parallel q/k/v and
    # gate/up, row-parallel o/down, FSDP on the other weight axis, experts
    # over "model"
    (r"embed$",                          ("model", None)),
    (r"lm_head$",                        (None, "model")),
    (r"final_norm$",                     ()),
    (r"attn/w[qkv]$",                    ("data", "model")),
    (r"attn/wo$",                        ("model", "data")),
    (r"attn/b[qkv]$",                    ("model",)),
    (r"(mlp|shared|dense)/w_(gate|up)$", ("data", "model")),
    (r"(mlp|shared|dense)/w_down$",      ("model", "data")),
    (r"moe/router$",                     ("data", None)),
    (r"moe/w_(gate|up)$",                ("model", "data", None)),
    (r"moe/w_down$",                     ("model", None, "data")),
    (r"ln[12]$",                         ()),
]


def lm_param_spec(path, leaf, mesh) -> Spec:
    s = _path_str(path)
    stacked = s.startswith("layers/")        # stacked: leading L axis
    for pat, spec in _LM_RULES:
        if re.search(pat, s):
            full = (None,) + spec if stacked else spec
            return _guard(full, _shape(leaf), mesh)
    return ()


def lm_specs(params_shape, mesh) -> Dict[str, NamedSharding]:
    """{path: NamedSharding} of an LM's parameters, ``params_shape`` a
    flat path-keyed dict of tensors (meta ones do) or shapes. A tied
    model (no ``lm_head``) shards its table's vocab rows, so the
    transposed head is vocab-parallel."""
    tied = "lm_head" not in params_shape

    def spec(p, leaf):
        if tied and re.search(r"embed$", _path_str(p)):
            return _guard(("model", None), _shape(leaf), mesh)
        return lm_param_spec(p, leaf, mesh)

    return {p: NamedSharding(mesh, spec(p, leaf))
            for p, leaf in params_shape.items()}


# the RecSys embedding tables, row-sharded over "model"
TABLE_PATHS = re.compile(r"tables/|^wide$|/wide$|^item$|^category$|^user$"
                         r"|^pos$")


def recsys_param_spec(path, leaf, mesh) -> Spec:
    s = _path_str(path)
    shape = _shape(leaf)
    if TABLE_PATHS.search(s):
        # embedding tables: row-sharded over model (the memory hot spot)
        return _guard(("model",), shape, mesh)
    if len(shape) == 2:
        # alternating column/row parallel, only for wide layers (>= 512)
        m = re.search(r"w(\d+)$", s)
        if m and int(m.group(1)) % 2 == 1 and shape[0] >= 512:
            return _guard(("model", None), shape, mesh)
        if shape[1] >= 512:
            return _guard((None, "model"), shape, mesh)
        return ()
    if len(shape) == 1 and shape[0] >= 512:
        return _guard(("model",), shape, mesh)
    return ()


def recsys_specs(params_shape, mesh) -> Dict[str, NamedSharding]:
    return {p: NamedSharding(mesh, recsys_param_spec(p, leaf, mesh))
            for p, leaf in params_shape.items()}


def gnn_specs(params_shape, mesh) -> Dict[str, NamedSharding]:
    """Every GNN parameter replicated (they are tiny; the node arrays are
    what shard)."""
    return {p: NamedSharding(mesh, ()) for p in params_shape}


def opt_state_specs(opt_state_shape, param_shardings, mesh):
    """The shardings of an AdamW, momentum or Adafactor state given the
    parameters': the moments follow their parameter's spec, Adafactor's
    factored moments drop the corresponding axis, scalars replicate; an
    unknown state is replicated whole."""
    from repro_torch.optim.adafactor import AdafactorState
    from repro_torch.optim.adamw import AdamWState, MomentumState

    rep = NamedSharding(mesh, ())

    def like_params(tree):
        return {k: param_shardings[k] for k in tree}

    if isinstance(opt_state_shape, AdamWState):
        return AdamWState(rep, like_params(opt_state_shape.m),
                          like_params(opt_state_shape.v))
    if isinstance(opt_state_shape, MomentumState):
        return MomentumState(rep, like_params(opt_state_shape.mom))
    if isinstance(opt_state_shape, AdafactorState):
        def vr_spec(leaf, shard):
            spec, shape = tuple(shard.spec), _shape(leaf)
            if len(spec) > len(shape):            # factored: dropped last
                spec = spec[:len(shape)]
            return NamedSharding(mesh, _guard(spec, shape, mesh))

        def vc_spec(leaf, shard):
            spec, shape = tuple(shard.spec), _shape(leaf)
            if len(shape) >= 1 and len(spec) >= 2:
                spec = spec[:-2] + spec[-1:]
            spec = spec[:len(shape)]
            return NamedSharding(mesh, _guard(spec, shape, mesh))

        vr = {k: vr_spec(v, param_shardings[k])
              for k, v in opt_state_shape.vr.items()}
        vc = {k: vc_spec(v, param_shardings[k])
              for k, v in opt_state_shape.vc.items()}
        return AdafactorState(rep, vr, vc)
    return _map_leaves(lambda _: rep, opt_state_shape)


def cache_specs(cache, mesh, batch: int):
    """The shardings of a decode cell's KV cache (an ``LMCache`` of tensors
    or shapes; None leaves stay None), the reference's choice for its
    ``batch`` rows: with at least one row a data process, the rows over
    the data axes and the sequence over "model" (batch-DP plus sequence
    parallelism); with fewer, the sequence over every axis, data major
    (pure sequence parallelism), the rows and ``length`` replicated. Every
    spec passes ``_guard``."""
    dp = dp_axes(mesh)
    n = 1
    for a in dp:
        n *= mesh_sizes(mesh)[a]
    rows = dp if len(dp) > 1 else (dp[0] if dp else None)
    if batch >= n:
        kv, ln = (None, rows, None, "model", None), (rows,)
    else:
        kv, ln = (None, None, None, dp + ("model",), None), (None,)

    def one(leaf):
        if leaf is None:
            return None
        shape = _shape(leaf)
        return NamedSharding(mesh, _guard(kv if len(shape) == 5 else ln,
                                          shape, mesh))
    return type(cache)(*(one(x) for x in cache))


def drop_fsdp(shardings, mesh=None):
    """The FSDP ("data") axis replaced by replication in a tree of
    shardings: the gather-once layout, each process holding its model
    shard of every parameter (``trainer.make_train_step``'s
    ``param_resharding``)."""
    def fix(ns):
        return NamedSharding(ns.mesh if mesh is None else mesh,
                             tuple(None if a == "data" else a
                                   for a in ns.spec))
    return _map_leaves(fix, shardings,
                       is_leaf=lambda x: isinstance(x, NamedSharding))


def _map_leaves(fn, tree, is_leaf=lambda x: False):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, is_leaf) for v in tree)
    return fn(tree)


# ---------------------------------------------------------------------------
# Placements on a DeviceMesh (port only)
# ---------------------------------------------------------------------------

def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placements(sharding: NamedSharding) -> list:
    """The DTensor placements of a spec on its ``DeviceMesh``, one a mesh
    dimension: ``Shard(d)`` for the axis that splits dimension d,
    ``Replicate()`` for an axis the spec does not name. A dimension split
    by a tuple of axes takes them in the mesh's order, major first, as
    the reference's mesh does."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(sharding.mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(sharding.spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {sharding.spec}: the axes {axes} of "
                             f"dimension {d} are not in the mesh's order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_slices(shape, sharding: NamedSharding) -> Tuple[slice, ...]:
    """This process's block of a leaf of ``shape`` placed by ``sharding``
    (even blocks: ``_guard`` keeps only axes that divide)."""
    mesh = sharding.mesh
    sizes = mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = []
    for d, n in enumerate(shape):
        axes = _axes(sharding.spec[d]) if d < len(sharding.spec) else ()
        parts, idx = 1, 0
        for a in axes:
            parts, idx = parts * sizes[a], idx * sizes[a] + coord[a]
        if n % parts:
            raise ValueError(f"spec {sharding.spec} does not divide "
                             f"dimension {d} of {tuple(shape)}")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def place(full: torch.Tensor, sharding: NamedSharding):
    """A DTensor of ``full`` (the whole value, the same on every process)
    placed by ``sharding``: each process keeps its own block, no
    collective."""
    from torch.distributed.tensor import DTensor
    if _is_dtensor(full):
        full = full.full_tensor()
    local = full[local_slices(full.shape, sharding)].contiguous()
    return DTensor.from_local(local, sharding.mesh, placements(sharding),
                              run_check=False)


def sharding_of(t) -> NamedSharding:
    """The ``NamedSharding`` of a DTensor: its mesh and the spec its
    placements make (``placements``' inverse)."""
    names = t.device_mesh.mesh_dim_names
    spec = [()] * t.ndim
    for i, pl in enumerate(t.placements):
        if pl.is_shard():
            spec[pl.dim % t.ndim] += (names[i],)
        elif not pl.is_replicate():
            raise ValueError(f"sharding_of: placement {pl} is neither a "
                             f"shard nor a replica")
    return NamedSharding(t.device_mesh, tuple(
        None if not a else a[0] if len(a) == 1 else a for a in spec))
