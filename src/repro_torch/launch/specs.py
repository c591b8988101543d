"""Dry-run cell builders: (arch x input shape) -> a step and its arguments.
Counterpart of ``repro/launch/specs.py``.

``build_cell(arch, shape)`` returns a ``Cell``: ``fn`` (the train step,
prefill, decode, serve or retrieval call, or the crawl step) and ``args``,
built on ``meta`` by default, so nothing is allocated: the reference's
``jax.eval_shape``. The same cell built on ``device="cuda"`` holds zeros
(valid ids, finite weights) of the same shapes, for measuring it on the
card. The reference's choices are kept:

- LM: ``_lm_optimizer`` (Adafactor for Arctic, bf16 AdamW moments above
  20 B parameters, f32 otherwise) and ``_lm_microbatches`` with dp = 1;
  ``variant="opt"`` means capacity factor 1.0 for an MoE (and the
  reference's ``causal_skip``, which the port's attention always does;
  its gather-once layout places nothing on one card).
- GNN: the cells' graphs, a minibatch block at ``_block_max_nodes`` /
  ``_block_max_edges`` (padding to a mesh multiple is padding to 1).
- RecSys: ``_recsys_batch_shapes``' leaves, dtypes and sizes.
- The crawl cell at ``webparf.CONFIG`` with ``n_shards`` shards (1 or 4
  batched on the card), its state from ``init_state`` on meta.

``batch`` overrides the shape's batch, ``seq_len`` an LM's length and
``cache_len`` an LM prefill's cache slots (the prompt's by default), so a
cell can be sized as ``chip_smoke.py`` runs it. Given a ``mesh`` (a
``DeviceMesh``, a mesh shape or a ``sharding.spmd.MetaMesh``), a train
cell also names the reference's ``in_shardings`` and ``out_shardings``
from the ported rules: the state's ``trainer.state_shardings`` (the
reference's ``_lm_state_shardings`` and its GNN and RecSys
counterparts), the batch split over the data axes, the metrics
replicated; an LM's microbatches count per data process. A prefill or
decode cell names ``_lm_cell``'s in-shardings (the parameters by
``lm_specs``, the tokens' rows and the KV cache by ``rules.cache_specs``)
and, on a ``DeviceMesh``, is placed. Under a ``MetaMesh`` a cell is one
process's program on its blocks on meta, which ``launch/dryrun.py``
reckons per card; ``mesh_program`` names the cells whose mesh program
the port does not run yet.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.base import (CrawlConfig, GNNConfig, LMConfig,
                                      RecSysConfig, ShapeSpec)
from repro_torch.device import resolve_device
from repro_torch.optim import adafactor, adamw
from repro_torch.train.trainer import init_train_state, make_train_step


class Cell(NamedTuple):
    arch: str
    shape: str
    fn: Callable
    args: tuple
    meta: dict
    in_shardings: Any = None       # given a mesh
    out_shardings: Any = None
    step_parts: Any = None         # a train cell's (loss_fn, optimizer)


def _mesh_kind(mesh) -> str:
    """"meta" (a ``spmd.MetaMesh``: one process's blocks on meta),
    "device" (a ``DeviceMesh``) or "shape"."""
    from repro_torch.sharding import rules, spmd
    if isinstance(mesh, spmd.MetaMesh):
        return "meta"
    return "device" if rules._is_device_mesh(mesh) else "shape"


def _block_shape(shape, sharding) -> tuple:
    from repro_torch.sharding import rules
    return tuple(s.stop - s.start for s in
                 rules.local_slices(tuple(shape), sharding))


def _blocks(tree, shardings, device):
    """This process's blocks of a tree of tensors placed by a tree of
    ``NamedSharding``s of the same structure, newly allocated on
    ``device`` (``_alloc``)."""
    from repro_torch.sharding import rules
    if isinstance(shardings, rules.NamedSharding):
        sh = rules.NamedSharding(shardings.mesh, rules._guard(
            shardings.spec, tree.shape, shardings.mesh))
        return _alloc(_block_shape(tree.shape, sh), tree.dtype, device)
    if shardings is None:
        return None
    if isinstance(tree, dict):
        return {k: _blocks(v, shardings[k], device) for k, v in tree.items()}
    return _rebuild(tree, [_blocks(v, sh, device)
                           for v, sh in zip(tree, shardings)])


def _rebuild(tree, parts):
    """A tuple or NamedTuple like ``tree`` of ``parts``."""
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def _block_cell(cell: Cell, mesh, family: str, kind: str) -> Cell:
    """A train cell as one process of ``mesh`` (a ``spmd.MetaMesh``) runs
    it: the state's blocks by the family's rules, its rows of the batch
    (a single graph whole on every process, as the port's trainer takes
    it), and ``trainer.make_train_step(..., shardings=)``."""
    from repro_torch.sharding import rules
    from repro_torch.train import trainer as TR
    cell = _train_shardings(cell, mesh, family, whole_graph=(
        kind in ("full_graph", "minibatch")))
    state, batch = cell.args
    state_sh, batch_sh = cell.in_shardings
    dev = torch.device("meta")
    loss_fn, opt = cell.step_parts
    step = TR.make_train_step(loss_fn, opt, shardings=state_sh.params,
                              microbatches=cell.meta.get("microbatches", 1))
    return cell._replace(fn=step, args=(_blocks(state, state_sh, dev),
                                        _blocks(batch, batch_sh, dev)),
                         meta={**cell.meta,
                               "mesh": dict(rules.mesh_sizes(mesh))})


def _train_shardings(cell: Cell, mesh, family: str, *,
                     whole_graph: bool = False) -> Cell:
    """``cell`` with the reference's in/out shardings on ``mesh``: the
    state by the family's rules, every batch leaf of the batch's rows
    split over the data axes (a leaf of other rows, BERT4Rec's shared
    negatives, replicated; a graph's nodes and edges both split, or with
    ``whole_graph`` a single graph whole, as the port's trainer takes
    it), the metrics replicated."""
    from repro_torch.sharding import rules
    from repro_torch.train import trainer as TR
    state, batch = cell.args
    state_sh = TR.state_shardings(state, mesh, family)
    rows = TR.batch_sharding(mesh)
    n = []
    TR._map(n.append, batch)
    rep = rules.NamedSharding(mesh, ())
    batch_sh = TR._map(lambda x: rules.NamedSharding(
        mesh, rows.spec[:x.dim()] if x.dim() and not whole_graph and (
            family == "gnn" or x.shape[0] == n[0].shape[0]) else ()), batch)
    metrics = {"loss": rep, "grad_norm": rep, "step": rep}
    return cell._replace(in_shardings=(state_sh, batch_sh),
                         out_shardings=(state_sh, metrics))


def _alloc(shape, dtype, device) -> torch.Tensor:
    """Storage-free on meta; zeros elsewhere (valid ids and finite
    weights, so the cell runs on the card)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_optimizer(cfg: LMConfig):
    """Arctic (477 B) trains with Adafactor, the factored second moment;
    above 20 B parameters AdamW keeps bf16 moments; the rest f32."""
    if cfg.name.startswith("arctic"):
        return adafactor(lr=1e-3)
    if cfg.n_params > 20e9:
        return adamw(lr=3e-4, state_dtype=torch.bfloat16)
    return adamw(lr=3e-4, state_dtype=torch.float32)


def _lm_microbatches(cfg: LMConfig, B: int, S: int, dp: int = 1) -> int:
    """Gradient-accumulation factor so the per-layer remat stash
    (L x B/dp x S x d bf16) stays under ~8 GiB a device."""
    stash = cfg.n_layers * (B // dp) * S * cfg.d_model * 2
    budget = 8 * 2 ** 30
    mb = 1
    while stash / mb > budget and mb < B // dp:
        mb *= 2
    return mb


def _lm_model(cfg: LMConfig, device):
    """An ``LM`` of the config: storage-free on meta, zeros elsewhere."""
    from repro_torch.models import transformer as T
    model = T.LM(cfg, device)
    if device.type != "meta":
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
    return model


def _lm_params(cfg: LMConfig, device) -> Dict[str, torch.Tensor]:
    """The stacked training leaves (``transformer.stack_params``' keys,
    shapes and dtypes), allocated once on ``device``."""
    from repro_torch.models import transformer as T
    shapes = T.stack_params(T.LM(cfg, "meta"))
    return {k: _alloc(v.shape, v.dtype, device) for k, v in shapes.items()}


def _lm_cell(arch: str, cfg: LMConfig, shape: ShapeSpec, variant: str,
             batch: Optional[int], seq_len: Optional[int],
             cache_len: Optional[int], microbatches: Optional[int],
             device, dp: int = 1, mesh=None) -> Cell:
    from repro_torch.models import transformer as T
    if variant == "opt" and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    B = batch or shape["global_batch"]
    S = seq_len or shape["seq_len"]
    meta = dict(family="lm", n_params=cfg.n_params,
                n_active_params=cfg.n_active_params, variant=variant,
                batch=B, seq_len=S, dtype=cfg.dtype)
    i32 = torch.int32
    if shape.kind == "train":
        opt = _lm_optimizer(cfg)
        mb = microbatches or _lm_microbatches(cfg, B, S, dp)
        meta.update(microbatches=mb, gather_once=False)
        state = init_train_state(_lm_params(cfg, device), opt)
        loss_fn = partial(_lm_loss, cfg)
        step = make_train_step(loss_fn, opt, microbatches=mb)
        toks = (_alloc((B, S), i32, device), _alloc((B, S), i32, device))
        return Cell(arch, shape.name, step, (state, toks), meta,
                    step_parts=(loss_fn, opt))
    max_len = (cache_len or S) if shape.kind == "prefill" else S
    if mesh is not None:
        return _lm_serve_mesh(arch, cfg, shape, B, S, max_len, meta, device,
                              mesh)
    model = _lm_model(cfg, device)
    if shape.kind == "prefill":
        meta["cache_len"] = max_len
        fn = partial(_prefill, max_len=max_len)
        return Cell(arch, shape.name, fn,
                    (model, _alloc((B, S), i32, device)), meta)
    assert shape.kind == "decode"
    cache = T.init_cache(cfg, B, S, device=device)
    return Cell(arch, shape.name, T.decode_step,
                (model, _alloc((B, 1), i32, device), cache), meta)


def _lm_loss(cfg, params, batch):
    from repro_torch.models import transformer as T
    return T.lm_loss(params, cfg, batch[0], batch[1])


def _prefill(model, tokens, *, max_len):
    from repro_torch.models import transformer as T
    return T.prefill_step(model, tokens, max_len=max_len)


def _lm_serve_mesh(arch, cfg, shape, B, S, max_len, meta, device,
                   mesh) -> Cell:
    """A prefill or decode cell on ``mesh`` with the reference's
    in-shardings (``_lm_cell``): the parameters by ``rules.lm_specs``, the
    tokens' rows and the KV cache by ``rules.cache_specs`` for B rows (a
    prefill's cache comes out in its decode cell's layout). On a mesh
    shape the arguments are whole and ``fn`` is one card's; on a
    ``spmd.MetaMesh`` they are one process's blocks on meta, and on a
    ``DeviceMesh`` DTensors of this process's blocks (zeros), and ``fn``
    is that process's program (``serve_on_mesh``)."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules
    meta.update(cache_len=max_len, mesh=dict(rules.mesh_sizes(mesh)))
    kind = shape.kind
    shapes = T.stack_params(T.LM(cfg, "meta"))
    psh = rules.lm_specs(shapes, mesh)
    layout = T.serve_layout(mesh, cfg, B, max_len)
    rows = (layout.rows[0] if len(layout.rows) == 1 else
            (layout.rows or None))
    n_tok = S if kind == "prefill" else 1
    tok_sh = rules.NamedSharding(mesh, rules._guard((rows, None), (B, n_tok),
                                                    mesh))
    cache = T.init_cache(cfg, B, max_len, device="meta")
    cache_sh = rules.cache_specs(cache, mesh, B)
    meta["layout"] = layout._asdict()
    in_sh = (psh, tok_sh) + ((cache_sh,) if kind == "decode" else ())
    mk = _mesh_kind(mesh)
    if mk == "shape":
        whole = _lm_cell(arch, cfg, shape, "baseline", B, S, max_len, None,
                         device)
        return whole._replace(meta={**whole.meta, **meta},
                              in_shardings=in_sh)
    dev = torch.device("meta") if mk == "meta" else device
    tok = _alloc((B, n_tok), torch.int32, torch.device("meta"))
    args = [_blocks(shapes, psh, dev), _blocks(tok, tok_sh, dev)]
    if kind == "decode":
        args.append(_blocks(cache, cache_sh, dev))
    if mk == "device":
        args = [_placed_tree(a, sh) for a, sh in zip(args, in_sh)]
    fn = partial(serve_on_mesh, kind, cfg, psh, layout, max_len)
    return Cell(arch, shape.name, fn, tuple(args), meta, in_shardings=in_sh)


def _placed_tree(tree, shardings):
    from repro_torch.sharding import rules
    from repro_torch.train.trainer import _placed
    if isinstance(shardings, rules.NamedSharding):
        return _placed(tree, shardings)
    if shardings is None:
        return None
    if isinstance(tree, dict):
        return {k: _placed_tree(v, shardings[k]) for k, v in tree.items()}
    return _rebuild(tree, [_placed_tree(v, sh)
                           for v, sh in zip(tree, shardings)])


def serve_on_mesh(kind, cfg, shardings, layout, max_len, params, tokens,
                  cache=None):
    """One process's prefill or decode on the mesh of ``shardings``: its
    parameter blocks (plain, or DTensors whose blocks are taken) as a
    ``spmd.Joined``, its token rows and cache block, under
    ``rules.activation_mesh`` of the mesh (``transformer.prefill_step`` /
    ``decode_step``)."""
    from repro_torch.models import transformer as T
    from repro_torch.optim.common import local
    from repro_torch.sharding import rules, spmd
    mesh = next(iter(shardings.values())).mesh
    J = spmd.Joined({k: local(v) for k, v in params.items()}, shardings)
    with rules.activation_mesh(mesh):
        if kind == "prefill":
            return T.prefill_step(J, local(tokens), max_len=max_len,
                                  cfg=cfg, layout=layout)
        cache = type(cache)(*(None if x is None else local(x)
                              for x in cache))
        return T.decode_step(J, local(tokens), cache, cfg=cfg,
                             layout=layout)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _graph(N: int, E: int, F: int, device, lead=()):
    from repro_torch.models import gnn as G
    return G.Graph(
        features=_alloc(lead + (N, F), torch.float32, device),
        src=_alloc(lead + (E,), torch.int32, device),
        dst=_alloc(lead + (E,), torch.int32, device),
        edge_mask=_alloc(lead + (E,), torch.bool, device),
        labels=_alloc(lead + (N,), torch.int32, device),
        label_mask=_alloc(lead + (N,), torch.bool, device))


def _gnn_cell(arch: str, cfg: GNNConfig, shape: ShapeSpec,
              batch: Optional[int], device) -> Cell:
    from repro_torch.data.sampler import _block_max_edges, _block_max_nodes
    from repro_torch.models import gnn as G
    opt = adamw(lr=5e-3)
    F, C = shape["d_feat"], shape["n_classes"]
    meta = dict(family="gnn")
    if shape.kind in ("full_graph", "minibatch"):
        if shape.kind == "full_graph":
            N, E = shape["n_nodes"], shape["n_edges"]
        else:
            seeds = batch or shape["batch_nodes"]
            fan = (shape["fanout0"], shape["fanout1"])
            N, E = _block_max_nodes(seeds, fan), _block_max_edges(seeds, fan)
            meta["batch_nodes"] = seeds
        graph = _graph(N, E, F, device)
        loss = G.gat_loss
        meta.update(n_nodes=N, n_edges=E)
    else:
        Bt = batch or shape["batch"]
        graph = _graph(shape["n_nodes"], shape["n_edges"], F, device, (Bt,))
        loss = G.gat_batched_loss
        meta["batch"] = Bt
    params = {k: _alloc(s, torch.float32, device)
              for k, (s, _) in G.param_shapes(cfg, F, C).items()}
    loss_fn = partial(_cfg_loss, loss, cfg)
    step = make_train_step(loss_fn, opt)
    return Cell(arch, shape.name, step,
                (init_train_state(params, opt), graph), meta,
                step_parts=(loss_fn, opt))


def _cfg_loss(loss, cfg, params, batch):
    return loss(params, cfg, batch)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _recsys_batch_shapes(cfg: RecSysConfig, shape: ShapeSpec, B: int,
                         device) -> Dict[str, Any]:
    """The leaves ``recsys.make_batch`` draws, at batch B, on ``device``."""
    from repro_torch.models import recsys as R
    i32, k = torch.int32, cfg.kind
    b: Dict[str, Any] = {}

    def add(name, shp, dtype=i32):
        b[name] = _alloc(shp, dtype, device)

    if k == "bert4rec":
        add("items", (B, cfg.seq_len))
        if shape.kind == "train":
            add("mask_pos", (B, R.N_MASK))
            add("targets", (B, R.N_MASK))
            add("neg_samples", (R.N_NEG,))
        if shape.kind == "retrieval":
            add("candidates", (shape["n_candidates"],))
    elif k == "dien":
        add("hist_items", (B, cfg.seq_len))
        add("hist_cats", (B, cfg.seq_len))
        add("hist_mask", (B, cfg.seq_len), torch.bool)
        add("user", (B,))
        add("target_item", (B,))
        add("target_cat", (B,))
        if shape.kind == "train":
            add("label", (B,), torch.float32)
        if shape.kind == "retrieval":
            add("candidates", (shape["n_candidates"],))
            add("cand_cats", (shape["n_candidates"],))
    elif k == "wide_deep":
        onehot = [n for n in sorted(cfg.tables) if n not in cfg.multi_hot]
        add("sparse_ids", (B, len(onehot)))
        b["bag_ids"] = {n: _alloc((B, bag), i32, device)
                        for n, bag in cfg.multi_hot.items()}
        add("wide_ids", (B, R.N_WIDE_CROSS))
        if shape.kind == "train":
            add("label", (B,), torch.float32)
        if shape.kind == "retrieval":
            add("candidates", (shape["n_candidates"],))
    elif k == "dcn_v2":
        add("dense", (B, cfg.n_dense), torch.float32)
        add("sparse_ids", (B, cfg.n_sparse))
        if shape.kind == "train":
            add("label", (B,), torch.float32)
        if shape.kind == "retrieval":
            add("candidates", (shape["n_candidates"],))
    else:
        raise ValueError(k)
    return b


def _recsys_params(cfg: RecSysConfig, device) -> Dict[str, torch.Tensor]:
    from repro_torch.models import recsys as R
    return {k: _alloc(s, torch.float32, device)
            for k, (s, _) in R.param_shapes(cfg).items()}


def _recsys_cell(arch: str, cfg: RecSysConfig, shape: ShapeSpec,
                 variant: str, batch: Optional[int], device) -> Cell:
    from repro_torch.models import recsys as R
    B = batch or shape.get("batch", 2)
    meta = dict(family="recsys", total_rows=cfg.total_rows, variant=variant,
                batch=B)
    params = _recsys_params(cfg, device)
    b = _recsys_batch_shapes(cfg, shape, B, device)
    if shape.kind == "train":
        opt = adamw(lr=1e-3)
        loss_fn = partial(_cfg_loss, R.TRAIN_LOSS[cfg.kind], cfg)
        step = make_train_step(loss_fn, opt)
        return Cell(arch, shape.name, step,
                    (init_train_state(params, opt), b), meta,
                    step_parts=(loss_fn, opt))
    fn_map = R.SERVE if shape.kind == "serve" else R.RETRIEVAL
    return Cell(arch, shape.name, partial(_call, fn_map[cfg.kind], cfg),
                (params, b), meta)


def _call(fn, cfg, params, batch):
    with torch.no_grad():
        return fn(params, cfg, batch)


# ---------------------------------------------------------------------------
# The WebParF crawl cell
# ---------------------------------------------------------------------------

def _crawl_cell(arch: str, cfg: CrawlConfig, shape: ShapeSpec,
                n_shards: int, device) -> Cell:
    from repro_torch.core import crawler as CR
    state = CR.init_state(cfg, n_shards, device)
    meta = dict(family="crawl", kernel_impl=cfg.kernel_impl,
                ordering=cfg.ordering, n_shards=n_shards,
                config=dataclasses.asdict(cfg))
    if device.type == "meta":
        # the step reads the host (frontier.py's FIFO rebase guard and
        # boolean-mask inserts, the router's and dispatch's nonzero), so
        # on meta only its state is built; dryrun reckons its temporaries
        return Cell(arch, shape.name, None, (state,), meta)
    step = CR.make_crawl_step(cfg, n_shards=n_shards, device=device)
    return Cell(arch, shape.name, partial(step, dispatch=True), (state,),
                meta)


def _crawl_block_cell(arch: str, cfg: CrawlConfig, shape: ShapeSpec,
                      mesh, n_shards: int) -> Cell:
    """The crawl cell as one data process of ``mesh`` holds it: the state
    of ``n_shards`` shards (one a data process) on meta, the leaves that
    ``state_specs`` splits cut to this process's rows."""
    from repro_torch.core import crawler as CR
    from repro_torch.core.stages import state_specs
    from repro_torch.sharding import rules, spmd
    whole = CR.init_state(cfg, n_shards, "meta")
    specs = state_specs()
    g = 0
    for a in rules.dp_axes(mesh):
        ax = spmd.Axis(mesh, a)
        g = g * ax.size + ax.index
    fields = {}
    for name in type(whole)._fields:
        t = getattr(whole, name)
        if getattr(specs, name) is not None:
            t = torch.empty((t.shape[0] // n_shards,) + tuple(t.shape[1:]),
                            dtype=t.dtype, device="meta")
        fields[name] = t
    meta = dict(family="crawl", kernel_impl=cfg.kernel_impl,
                ordering=cfg.ordering, n_shards=n_shards, n_local=1,
                shard=g, config=dataclasses.asdict(cfg),
                mesh=dict(rules.mesh_sizes(mesh)))
    return Cell(arch, shape.name, None, (type(whole)(**fields),), meta)


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------

# the cells whose mesh program the port does not run yet (ROADMAP item
# 19d): the reference splits their batch, candidates, or nodes and edges
# over the data axes
NOT_PORTED_ON_MESH = {
    ("recsys", "serve"): "the reference splits the serving batch over the "
                         "data axes; the port serves RecSys on one card",
    ("recsys", "retrieval"): "the reference splits the candidates over the "
                             "data axes; the port retrieves on one card",
    ("gnn", "full_graph"): "the reference splits the graph's nodes and "
                           "edges over the data axes; the port's trainer "
                           "computes the whole graph on every process"}


def mesh_program(arch: str, shape_name: str) -> Optional[str]:
    """None when the port runs the cell's mesh program, else why not."""
    cfg, _ = get_arch(arch)
    kind = get_shape(arch, shape_name).kind
    return NOT_PORTED_ON_MESH.get((getattr(cfg, "family", None), kind))


def build_cell(arch: str, shape_name: str, *, variant: str = "baseline",
               batch: Optional[int] = None, seq_len: Optional[int] = None,
               cache_len: Optional[int] = None, n_shards: int = 1,
               microbatches: Optional[int] = None, device="meta",
               cfg=None, mesh=None) -> Cell:
    """The cell's step and its arguments on ``device`` (meta: no storage).
    ``cfg`` replaces the arch's config (a cut depth, a crawl ordering);
    ``microbatches`` an LM train step's (``_lm_microbatches`` by default).
    ``mesh`` gives a train, prefill or decode cell the reference's
    shardings; under a ``spmd.MetaMesh`` (device meta) the cell is that
    process's program on its blocks (a train cell's step
    ``trainer.make_train_step(..., shardings=)``; the crawl cell's state
    at one shard a data process, its rows by
    ``core.stages.state_specs``), and on a
    ``DeviceMesh`` a serving cell is placed. A cell whose mesh program
    the port does not run (``mesh_program``) raises under a
    ``MetaMesh``."""
    dev = resolve_device(device)
    if cfg is None:
        cfg, _ = get_arch(arch)
    shape = get_shape(arch, shape_name)
    family = getattr(cfg, "family", None)
    dp = 1
    mk = None if mesh is None else _mesh_kind(mesh)
    if mesh is not None:
        from repro_torch.sharding import rules
        sizes = rules.mesh_sizes(mesh)
        for a in rules.dp_axes(mesh):
            dp *= sizes[a]
        why = NOT_PORTED_ON_MESH.get((family, shape.kind))
        if mk == "meta" and why:
            raise ValueError(f"{arch} {shape_name}: no mesh program: {why}")
        if mk == "meta" and dev.type != "meta":
            raise ValueError("a MetaMesh cell is built on meta")
    if family == "lm":
        cell = _lm_cell(arch, cfg, shape, variant, batch, seq_len,
                        cache_len, microbatches, dev, dp, mesh)
    elif family == "gnn":
        cell = _gnn_cell(arch, cfg, shape, batch, dev)
    elif family == "recsys":
        cell = _recsys_cell(arch, cfg, shape, variant, batch, dev)
    elif family == "crawl":
        if mk == "meta":
            return _crawl_block_cell(arch, cfg, shape, mesh, dp)
        return _crawl_cell(arch, cfg, shape, n_shards, dev)
    else:
        raise ValueError(f"unknown family for {arch}")
    train = shape.kind in ("train", "full_graph", "minibatch",
                           "batched_graphs")
    if mesh is None or not train:
        return cell
    if mk == "meta":
        return _block_cell(cell, mesh, family, shape.kind)
    return _train_shardings(cell, mesh, family)
