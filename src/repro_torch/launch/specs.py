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
``DeviceMesh`` or a mesh shape), a train cell also names the reference's
``in_shardings`` and ``out_shardings`` from the ported rules: the state's
``trainer.state_shardings`` (the reference's ``_lm_state_shardings`` and
its GNN and RecSys counterparts), the batch split over the data axes, the
metrics replicated; an LM's microbatches count per data process. The
per-card reckoning of a mesh cell is not made here.
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
    in_shardings: Any = None       # a train cell's, given a mesh
    out_shardings: Any = None


def _train_shardings(cell: Cell, mesh, family: str) -> Cell:
    """``cell`` with the reference's in/out shardings on ``mesh``: the
    state by the family's rules, every batch leaf of the batch's rows
    split over the data axes (a leaf of other rows, BERT4Rec's shared
    negatives, replicated; a graph's nodes and edges both split), the
    metrics replicated."""
    from repro_torch.sharding import rules
    from repro_torch.train import trainer as TR
    state, batch = cell.args
    state_sh = TR.state_shardings(state, mesh, family)
    rows = TR.batch_sharding(mesh)
    n = []
    TR._map(n.append, batch)
    rep = rules.NamedSharding(mesh, ())
    batch_sh = TR._map(lambda x: rules.NamedSharding(
        mesh, rows.spec[:x.dim()] if x.dim() and (
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
             device, dp: int = 1) -> Cell:
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
        step = make_train_step(
            lambda p, b: T.lm_loss(p, cfg, b[0], b[1]), opt,
            microbatches=mb)
        toks = (_alloc((B, S), i32, device), _alloc((B, S), i32, device))
        return Cell(arch, shape.name, step, (state, toks), meta)
    model = _lm_model(cfg, device)
    if shape.kind == "prefill":
        max_len = cache_len or S
        meta["cache_len"] = max_len
        fn = partial(_prefill, max_len=max_len)
        return Cell(arch, shape.name, fn,
                    (model, _alloc((B, S), i32, device)), meta)
    assert shape.kind == "decode"
    cache = T.init_cache(cfg, B, S, device=device)
    return Cell(arch, shape.name, T.decode_step,
                (model, _alloc((B, 1), i32, device), cache), meta)


def _prefill(model, tokens, *, max_len):
    from repro_torch.models import transformer as T
    return T.prefill_step(model, tokens, max_len=max_len)


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
    step = make_train_step(lambda p, b: loss(p, cfg, b), opt)
    return Cell(arch, shape.name, step,
                (init_train_state(params, opt), graph), meta)


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
        step = make_train_step(
            lambda p, x: R.TRAIN_LOSS[cfg.kind](p, cfg, x), opt)
        return Cell(arch, shape.name, step,
                    (init_train_state(params, opt), b), meta)
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


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, *, variant: str = "baseline",
               batch: Optional[int] = None, seq_len: Optional[int] = None,
               cache_len: Optional[int] = None, n_shards: int = 1,
               microbatches: Optional[int] = None, device="meta",
               cfg=None, mesh=None) -> Cell:
    """The cell's step and its arguments on ``device`` (meta: no storage).
    ``cfg`` replaces the arch's config (a cut depth, a crawl ordering);
    ``microbatches`` an LM train step's (``_lm_microbatches`` by default);
    ``mesh`` gives a train cell its shardings."""
    dev = resolve_device(device)
    if cfg is None:
        cfg, _ = get_arch(arch)
    shape = get_shape(arch, shape_name)
    family = getattr(cfg, "family", None)
    dp = 1
    if mesh is not None:
        from repro_torch.sharding import rules
        sizes = rules.mesh_sizes(mesh)
        for a in rules.dp_axes(mesh):
            dp *= sizes[a]
    if family == "lm":
        cell = _lm_cell(arch, cfg, shape, variant, batch, seq_len,
                        cache_len, microbatches, dev, dp)
    elif family == "gnn":
        cell = _gnn_cell(arch, cfg, shape, batch, dev)
    elif family == "recsys":
        cell = _recsys_cell(arch, cfg, shape, variant, batch, dev)
    elif family == "crawl":
        return _crawl_cell(arch, cfg, shape, n_shards, dev)
    else:
        raise ValueError(f"unknown family for {arch}")
    train = shape.kind in ("train", "full_graph", "minibatch",
                           "batched_graphs")
    if mesh is None or not train:
        return cell
    return _train_shardings(cell, mesh, family)
