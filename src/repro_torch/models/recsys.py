"""RecSys family: BERT4Rec, DIEN, Wide&Deep, DCN-v2, and the MLP of the
learned URL ranker. Counterpart of ``repro/models/recsys.py``.

The embedding lookup is the hot path. As in the reference it is a clipped
row gather (``jnp.take(..., mode="clip")``: an id below 0 reads row 0, one
past the end the last row) and the embedding bag a gather followed by a
per-example sum. The gathers are ``models/segment.py``'s: their backward
is a segment sum in a fixed order, so a table's gradient (dense, as the
reference's) comes out the same bits on every run on the card.
``sharded_lookup`` is the single-card form of the reference's mesh
lookup: the table split into ``n_shards`` row ranges along a leading axis.

``retrieval_*`` scores one query against 10^6 candidates as a batched dot
and a top-k; ``bert4rec_serve`` keeps a running top-k over table chunks.
Every top-k is a stable descending sort, so ties go to the lower index as
``lax.top_k`` and the reference's stable merge give them.

Parameters are flat dicts keyed by the reference's checkpoint paths
(``item``, ``blocks/0/wq``, ``gru1/wx``, ``tables/cat_0``, ``cross/1/b``,
``deep/w0``, ...), so they carry across by name, train with
``repro_torch.optim`` and save with ``train/checkpoint``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecSysConfig
from repro_torch.device import Device, resolve_device
from repro_torch.models.segment import Segments, gather
from repro_torch.optim import common

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------

def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Clipped row gather: (...) int -> (..., d). A table placed on a train
    mesh with its rows split over the model axis (a ``spmd.RowBlock``, as
    ``mesh_params`` hands it on) is looked up row-parallel
    (``spmd.row_parallel_lookup``): the same bits."""
    idx = ids.long().clamp(0, table.shape[0] - 1)
    from repro_torch.sharding import spmd
    if isinstance(table, spmd.RowBlock):
        return spmd.row_parallel_lookup(
            table.to_local(), idx, spmd.Axis(table.device_mesh, "model"),
            _fetch)
    return _fetch(table, idx)


def _fetch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows ``idx`` (within the table) of ``table``."""
    return gather(table, Segments(idx, table.shape[0])).reshape(
        *idx.shape, *table.shape[1:])


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, *,
                  mode: str = "mean",
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding bag over multi-hot ids (B, bag) -> (B, d): every id's row
    gathered, then each example's rows reduced. ``mode="max"`` ignores
    ``valid``, as the reference's does."""
    B, bag = ids.shape
    rows = embedding_lookup(table, ids)                 # (B, bag, d)
    if mode == "max":
        return rows.amax(dim=1)
    if valid is not None:
        rows = rows * valid[..., None].to(rows.dtype)
    out = rows.sum(dim=1)
    if mode == "mean":
        cnt = (torch.full((B,), float(bag), dtype=rows.dtype,
                          device=rows.device) if valid is None
               else valid.to(rows.dtype).sum(dim=1))
        out = out / torch.clamp(cnt[:, None], min=1.0)
    return out


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                   n_shards: Optional[int] = None, mesh=None,
                   model_axis: str = "model", data_axes=None
                   ) -> torch.Tensor:
    """The reference's model-sharded lookup. On a train mesh (``mesh`` a
    ``DeviceMesh``, the reference's signature): ``table`` is this
    process's block of rows, ``ids`` this data process's ids; each model
    process gathers only its row range and the axis adds the parts
    (``spmd.row_parallel_lookup``, the reference's ``psum``): the ids'
    rows' bits, -0.0 too. On one card: the table split into ``n_shards``
    row ranges along a leading axis, and the ``psum`` a sum over that
    axis. An id outside the table reads zeros. The rows must split
    evenly, as the reference's ``shard_map`` requires."""
    if mesh is not None:
        from repro_torch.sharding import spmd
        tp = spmd.Axis(mesh, model_axis)
        rows = table.shape[0] * tp.size
        i = ids.long()
        got = spmd.row_parallel_lookup(table, i.clamp(0, rows - 1), tp,
                                       _fetch)
        ok = (i >= 0) & (i < rows)
        return torch.where(ok[..., None], got, 0.0)
    rows, d = table.shape
    if rows % n_shards:
        raise ValueError(f"{rows} rows do not split into {n_shards} shards")
    per = rows // n_shards
    shards = table.reshape(n_shards, per, d)
    lo = (torch.arange(n_shards, device=ids.device) * per).reshape(
        (n_shards,) + (1,) * ids.dim())
    rel = ids.long()[None] - lo                         # (S, ...)
    ok = (rel >= 0) & (rel < per)
    got = shards[torch.arange(n_shards, device=ids.device).reshape(
        lo.shape), rel.clamp(0, per - 1)]               # (S, ..., d)
    return torch.where(ok[..., None], got, torch.zeros_like(got)).sum(0)


def mlp(params: Params, x: torch.Tensor, *,
        final_act: Optional[Callable] = None) -> torch.Tensor:
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return final_act(x) if final_act else x


def init_mlp_params(seed: int, dims: Sequence[int],
                    dtype: torch.dtype = torch.float32, *,
                    device: Device = None) -> Params:
    """N(0, 1/fan_in) weights and zero biases, the reference's shapes and
    scales, drawn from a ``torch.Generator`` on the device seeded with
    ``seed`` (the reference draws from a JAX key: carry its weights across
    by name for equal values). Runs on cuda unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {}
    for i in range(len(dims) - 1):
        p[f"w{i}"] = torch.randn((dims[i], dims[i + 1]), generator=gen,
                                 dtype=dtype, device=dev) * dims[i] ** -0.5
        p[f"b{i}"] = torch.zeros((dims[i + 1],), dtype=dtype, device=dev)
    return p


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: a stable descending sort, ties
    to the lower index; int32 ids, as the reference's."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k].int()


def chunked_topk_scores(query: torch.Tensor, table: torch.Tensor, *,
                        k: int = 100, chunk: int = 16384
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (B, d) x table (V, d) -> (top-k scores, ids) without the full
    (B, V) score matrix: the reference's running merge, chunk by chunk,
    the best k first and then the chunk, one stable descending sort each
    (ids past V, in the last chunk's padding, score -inf). The reference's
    ``opt_barrier`` and three ``constrain`` calls (recsys.py:128-139) keep
    XLA from hoisting the chunks and place the running state on a mesh:
    eager PyTorch runs chunk by chunk, and one card has no mesh."""
    B = query.shape[0]
    V = table.shape[0]
    chunk = min(chunk, V)
    n = -(-V // chunk)
    dev = query.device
    best_s = torch.full((B, k), float("-inf"), dtype=query.dtype, device=dev)
    best_i = torch.zeros((B, k), dtype=torch.int32, device=dev)
    ar = torch.arange(chunk, dtype=torch.int32, device=dev)
    for j in range(n):
        s = query @ table[j * chunk:(j + 1) * chunk].T   # (B, <= chunk)
        if s.shape[1] < chunk:
            s = F.pad(s, (0, chunk - s.shape[1]), value=float("-inf"))
        cs = torch.cat([best_s, s], dim=1)
        ci = torch.cat([best_i, (j * chunk + ar).expand(B, chunk)], dim=1)
        order = torch.sort(cs, dim=1, descending=True,
                           stable=True).indices[:, :k]
        best_s, best_i = cs.gather(1, order), ci.gather(1, order)
    return best_s, best_i


def _bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The stable logistic loss. At a logit of exactly 0 (a dead ReLU
    trunk leaves the zero-initialised bias) its gradient is JAX's: the max
    splits it between its operands (as ``torch.maximum`` does) and |z|
    takes the slope +1 (``torch.abs`` would take 0)."""
    z = logit.float()
    mag = torch.where(z >= 0, z, -z)
    return torch.mean(torch.maximum(z, torch.zeros_like(z)) - z * label
                      + torch.log1p(torch.exp(-mag)))


def _sub(params: Params, prefix: str) -> Params:
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def _count(params: Params, prefix: str) -> int:
    pre = prefix + "/"
    return 1 + max(int(k[len(pre):].split("/")[0]) for k in params
                   if k.startswith(pre))


def _mlp_shapes(prefix: str, dims: Sequence[int]):
    out = {}
    for i in range(len(dims) - 1):
        out[f"{prefix}/w{i}"] = ((dims[i], dims[i + 1]), dims[i] ** -0.5)
        out[f"{prefix}/b{i}"] = ((dims[i + 1],), "zeros")
    return out


# ===========================================================================
# BERT4Rec: bidirectional transformer over item sequences
# ===========================================================================

def _bert4rec_shapes(cfg: RecSysConfig):
    d = cfg.embed_dim
    V = cfg.tables["item"]
    out = {"item": ((V + 2, d), d ** -0.5),          # +mask, +pad
           "pos": ((cfg.seq_len, d), d ** -0.5),
           "out_ln": ((d,), "ones")}
    for b in range(cfg.n_blocks):
        for w in ("wq", "wk", "wv", "wo"):
            out[f"blocks/{b}/{w}"] = ((d, d), d ** -0.5)
        out[f"blocks/{b}/ln1"] = ((d,), "ones")
        out[f"blocks/{b}/ln2"] = ((d,), "ones")
        out.update(_mlp_shapes(f"blocks/{b}/ffn", (d, 4 * d, d)))
    return out


def _ln(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's norm: population variance, eps inside the rsqrt,
    no bias."""
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, correction=0)
    return (x - m) * torch.rsqrt(v + eps) * g


def bert4rec_encode(params: Params, cfg: RecSysConfig,
                    items: torch.Tensor) -> torch.Tensor:
    """items (B, L) -> hidden (B, L, d). Bidirectional (encoder-only)."""
    B, L = items.shape
    d, H = cfg.embed_dim, cfg.n_heads
    hd = d // H
    x = embedding_lookup(params["item"], items) + params["pos"][None, :L]
    for b in range(_count(params, "blocks")):
        blk = _sub(params, f"blocks/{b}")
        z = _ln(x, blk["ln1"])
        q, k, v = ((z @ blk[w]).reshape(B, L, H, hd).transpose(1, 2)
                   for w in ("wq", "wk", "wv"))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        a = torch.softmax(s, dim=-1)
        o = (a @ v).transpose(1, 2).reshape(B, L, d)
        x = x + o @ blk["wo"]
        x = x + mlp(_sub(blk, "ffn"), _ln(x, blk["ln2"]))
    return _ln(x, params["out_ln"])


def bert4rec_train_loss(params: Params, cfg: RecSysConfig, batch
                        ) -> torch.Tensor:
    """Masked-item prediction with shared sampled negatives."""
    h = bert4rec_encode(params, cfg, batch["items"])            # (B, L, d)
    B, L, d = h.shape
    pos = batch["mask_pos"].long() + L * torch.arange(
        B, device=h.device)[:, None]
    hm = gather(h.reshape(B * L, d), Segments(pos, B * L)).reshape(
        B, -1, d)                                               # (B, M, d)
    gold_e = embedding_lookup(params["item"], batch["targets"])  # (B, M, d)
    neg_e = embedding_lookup(params["item"], batch["neg_samples"])  # (NS, d)
    gold = (hm * gold_e).sum(-1, keepdim=True)                  # (B, M, 1)
    neg = hm @ neg_e.T                                          # (B, M, NS)
    logz = torch.logsumexp(torch.cat([gold, neg], dim=-1), dim=-1)
    return torch.mean(logz - gold[..., 0])


def bert4rec_serve(params: Params, cfg: RecSysConfig, batch):
    """Next-item top-k at the final position (the model's serving mode)."""
    h = bert4rec_encode(params, cfg, batch["items"])[:, -1]     # (B, d)
    return chunked_topk_scores(h, params["item"][: cfg.tables["item"]],
                               k=100)


def bert4rec_retrieval(params: Params, cfg: RecSysConfig, batch):
    h = bert4rec_encode(params, cfg, batch["items"])[:, -1]     # (1, d)
    cand = embedding_lookup(params["item"], batch["candidates"])  # (C, d)
    return top_k(h @ cand.T, 100)


# ===========================================================================
# DIEN: GRU interest extraction + AUGRU interest evolution
# ===========================================================================

def _gru_shapes(prefix: str, d_in: int, d_h: int):
    return {f"{prefix}/wx": ((d_in, 3 * d_h), d_in ** -0.5),
            f"{prefix}/wh": ((d_h, 3 * d_h), d_h ** -0.5),
            f"{prefix}/b": ((3 * d_h,), "zeros")}


def _init_gru(seed: int, d_in: int, d_h: int, *,
              device: Device = None) -> Params:
    return {k.split("/")[-1]: v for k, v in _draw(
        _gru_shapes("gru", d_in, d_h), seed, device).items()}


def _gru_cell(p: Params, x: torch.Tensor, h: torch.Tensor,
              a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's cell, not cuDNN's GRU: one bias, on the x side;
    n = tanh(xn + r * hn) with no bias on hn; gates r, z, n. With ``a``
    (AUGRU) the attention scales the update gate."""
    gx = torch.addmm(p["b"], x, p["wx"])                # x @ wx + b
    gh = h @ p["wh"]
    xr, xz, xn = gx.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    if a is not None:                      # AUGRU: attention-scaled update gate
        z = a[:, None] * z
    return (1.0 - z) * h + z * n


def _dien_shapes(cfg: RecSysConfig):
    d, gd = cfg.embed_dim, cfg.gru_dim
    d_in = 2 * d                           # item ++ category
    out = {name: ((cfg.tables[name], d), d ** -0.5)
           for name in ("item", "category", "user")}
    out.update(_gru_shapes("gru1", d_in, gd))
    out.update(_gru_shapes("gru2", gd, gd))
    out["att_w"] = ((gd, d_in), gd ** -0.5)
    # final MLP: [user, target, final interest] -> 200 -> 80 -> 1
    out.update(_mlp_shapes("mlp", (d + d_in + gd,) + tuple(cfg.mlp_dims)
                           + (1,)))
    return out


def _gru_scan(p: Params, xs: torch.Tensor, mask: torch.Tensor,
              att: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's ``lax.scan`` over the history, the state kept where
    a step is masked out. xs (B, S, d_in) -> every step's state (B, S,
    d_h), or with ``att`` (the AUGRU) the last state (B, d_h). Each step
    makes its own x @ wx, as the reference's does: one product over all
    steps at once would hold (B, S, 3 d_h) floats, 34 GB at serve_bulk."""
    B, S, _ = xs.shape
    h = xs.new_zeros((B, p["wh"].shape[0]))
    hs = []
    for t in range(S):
        h2 = _gru_cell(p, xs[:, t], h, None if att is None else att[:, t])
        h = torch.where(mask[:, t, None] > 0, h2, h)
        hs.append(h)
    return h if att is not None else torch.stack(hs, dim=1)


def dien_user_state(params: Params, cfg: RecSysConfig, batch):
    """History -> (final evolved interest state (B, gru_dim), target)."""
    hist = torch.cat([
        embedding_lookup(params["item"], batch["hist_items"]),
        embedding_lookup(params["category"], batch["hist_cats"]),
    ], dim=-1)                                          # (B, S, 2d)
    mask = batch["hist_mask"].float()                   # (B, S)
    hs = _gru_scan(_sub(params, "gru1"), hist, mask)    # (B, S, gd)
    tgt = torch.cat([
        embedding_lookup(params["item"], batch["target_item"]),
        embedding_lookup(params["category"], batch["target_cat"]),
    ], dim=-1)                                          # (B, 2d)
    # einsum("bsg,gd,bd->bs"), contracted as hs . (att_w . tgt)
    att = (hs @ (tgt @ params["att_w"].T)[:, :, None])[..., 0]
    att = torch.where(mask > 0, att, torch.full_like(att, -1e30))
    att = torch.softmax(att, dim=-1)                    # (B, S)
    hfin = _gru_scan(_sub(params, "gru2"), hs, mask, att)
    return hfin, tgt


def dien_logit(params: Params, cfg: RecSysConfig, batch) -> torch.Tensor:
    hfin, tgt = dien_user_state(params, cfg, batch)
    u = embedding_lookup(params["user"], batch["user"])  # (B, d)
    feats = torch.cat([u, tgt, hfin], dim=-1)
    return mlp(_sub(params, "mlp"), feats)[:, 0]


def dien_train_loss(params, cfg, batch):
    return _bce(dien_logit(params, cfg, batch), batch["label"])


def dien_serve(params, cfg, batch):
    return torch.sigmoid(dien_logit(params, cfg, batch))


def dien_retrieval(params: Params, cfg: RecSysConfig, batch):
    """User interest state scored against 1M candidate item embeddings."""
    # a neutral target (the last history item) evolves the interests
    b = dict(batch)
    b["target_item"] = batch["hist_items"][:, -1]
    b["target_cat"] = batch["hist_cats"][:, -1]
    hfin, _ = dien_user_state(params, cfg, b)           # (1, gd)
    q = hfin @ params["att_w"]                          # (1, 2d) item space
    cand = torch.cat([
        embedding_lookup(params["item"], batch["candidates"]),
        embedding_lookup(params["category"], batch["cand_cats"]),
    ], dim=-1)                                          # (C, 2d)
    return top_k(q @ cand.T, 100)


# ===========================================================================
# Wide&Deep
# ===========================================================================

N_WIDE_BUCKETS = 1_000_000
N_WIDE_CROSS = 32


def _wide_deep_shapes(cfg: RecSysConfig):
    e = cfg.embed_dim
    out = {f"tables/{name}": ((rows, e), e ** -0.5)
           for name, rows in sorted(cfg.tables.items())}
    out.update(_mlp_shapes("deep", (len(cfg.tables) * e,)
                           + tuple(cfg.mlp_dims) + (1,)))
    out["wide"] = ((N_WIDE_BUCKETS,), 0.01)
    out["retrieval_proj"] = ((cfg.mlp_dims[-1], e), cfg.mlp_dims[-1] ** -0.5)
    return out


def _wide_deep_embed(params: Params, cfg: RecSysConfig, batch
                     ) -> torch.Tensor:
    cols = []
    onehot_i = 0
    for name in sorted(cfg.tables):
        table = params[f"tables/{name}"]
        if name in cfg.multi_hot:
            cols.append(embedding_bag(table, batch["bag_ids"][name],
                                      mode="mean"))
        else:
            cols.append(embedding_lookup(table,
                                         batch["sparse_ids"][:, onehot_i]))
            onehot_i += 1
    return torch.cat(cols, dim=-1)


def wide_deep_logit(params: Params, cfg: RecSysConfig, batch
                    ) -> torch.Tensor:
    deep = mlp(_sub(params, "deep"), _wide_deep_embed(params, cfg, batch))
    # wide: hashed cross features, multi-hot sum of scalar weights
    wide = embedding_bag(_column(params["wide"]), batch["wide_ids"],
                         mode="sum")[:, 0]
    return deep[:, 0] + wide


def _column(w: torch.Tensor) -> torch.Tensor:
    """A (rows,) weight as a (rows, 1) table, placed as it is."""
    from repro_torch.sharding import spmd
    if isinstance(w, spmd.RowBlock):
        return spmd.RowBlock(w.block[:, None], w.device_mesh, w.rows)
    return w[:, None]


def wide_deep_train_loss(params, cfg, batch):
    return _bce(wide_deep_logit(params, cfg, batch), batch["label"])


def wide_deep_serve(params, cfg, batch):
    return torch.sigmoid(wide_deep_logit(params, cfg, batch))


def wide_deep_retrieval(params: Params, cfg: RecSysConfig, batch):
    """Two-tower factorisation: user tower = deep MLP trunk -> proj; item
    tower = the first sparse table's embeddings."""
    x = _wide_deep_embed(params, cfg, batch)
    deep = _sub(params, "deep")
    n = len([k for k in deep if k.startswith("w")])
    for i in range(n - 1):                              # all but the last layer
        x = torch.relu(x @ deep[f"w{i}"] + deep[f"b{i}"])
    u = x @ params["retrieval_proj"]                    # (1, d)
    first = sorted(cfg.tables)[0]
    cand = embedding_lookup(params[f"tables/{first}"], batch["candidates"])
    return top_k(u @ cand.T, 100)


# ===========================================================================
# DCN-v2
# ===========================================================================

def _dcn_v2_shapes(cfg: RecSysConfig):
    e = cfg.embed_dim
    out = {f"tables/{name}": ((rows, e), e ** -0.5)
           for name, rows in sorted(cfg.tables.items())}
    d0 = cfg.n_dense + cfg.n_sparse * e
    for i in range(cfg.n_cross_layers):
        out[f"cross/{i}/w"] = ((d0, d0), d0 ** -0.5)
        out[f"cross/{i}/b"] = ((d0,), "zeros")
    out.update(_mlp_shapes("deep", (d0,) + tuple(cfg.mlp_dims)))
    top = cfg.mlp_dims[-1] + d0
    out.update(_mlp_shapes("head", (top, 1)))
    out["retrieval_proj"] = ((top, e), top ** -0.5)
    return out


def _dcn_x0(params: Params, cfg: RecSysConfig, batch) -> torch.Tensor:
    embeds = [embedding_lookup(params[f"tables/{name}"],
                               batch["sparse_ids"][:, i])
              for i, name in enumerate(sorted(cfg.tables))]
    return torch.cat([batch["dense"]] + embeds, dim=-1)  # (B, d0)


def dcn_v2_trunk(params: Params, cfg: RecSysConfig, batch) -> torch.Tensor:
    x0 = _dcn_x0(params, cfg, batch)
    x = x0
    for i in range(_count(params, "cross")):
        c = _sub(params, f"cross/{i}")
        x = x0 * (x @ c["w"] + c["b"]) + x              # DCN-v2 cross
    deep = mlp(_sub(params, "deep"), x0, final_act=torch.relu)
    return torch.cat([x, deep], dim=-1)


def dcn_v2_logit(params, cfg, batch):
    return mlp(_sub(params, "head"), dcn_v2_trunk(params, cfg, batch))[:, 0]


def dcn_v2_train_loss(params, cfg, batch):
    return _bce(dcn_v2_logit(params, cfg, batch), batch["label"])


def dcn_v2_serve(params, cfg, batch):
    return torch.sigmoid(dcn_v2_logit(params, cfg, batch))


def dcn_v2_retrieval(params: Params, cfg: RecSysConfig, batch):
    u = dcn_v2_trunk(params, cfg, batch) @ params["retrieval_proj"]  # (1, d)
    first = sorted(cfg.tables)[0]
    cand = embedding_lookup(params[f"tables/{first}"], batch["candidates"])
    return top_k(u @ cand.T, 100)


# ===========================================================================
# Init, weights across packages, dispatch tables
# ===========================================================================

_SHAPES = {"bert4rec": _bert4rec_shapes, "dien": _dien_shapes,
           "wide_deep": _wide_deep_shapes, "dcn_v2": _dcn_v2_shapes}


def param_shapes(cfg: RecSysConfig
                 ) -> Dict[str, Tuple[Tuple[int, ...], object]]:
    """Each parameter's shape and its init: the scale of an N(0, 1) draw,
    or "zeros" / "ones"."""
    return _SHAPES[cfg.kind](cfg)


def _draw(shapes, seed: int, device: Device) -> Params:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for k, (shape, init) in shapes.items():
        if init == "zeros":
            out[k] = torch.zeros(shape, device=dev)
        elif init == "ones":
            out[k] = torch.ones(shape, device=dev)
        else:
            out[k] = torch.randn(shape, generator=gen, device=dev).mul_(init)
    return out


def _init(seed: int, cfg: RecSysConfig, *, device: Device = None) -> Params:
    """The reference's shapes and scales, drawn from a ``torch.Generator``
    on the device seeded with ``seed`` (carry JAX's weights across with
    ``params_from_numpy`` for equal values). Runs on cuda unless
    ``device`` says otherwise."""
    return _draw(param_shapes(cfg), seed, device)


init_bert4rec = init_dien = init_wide_deep = init_dcn_v2 = _init


def params_from_numpy(cfg: RecSysConfig, flat: Dict[str, np.ndarray], *,
                      device: Device = None) -> Params:
    """The flat, path-keyed numpy leaves of a RecSys model in the
    reference's checkpoint form (``repro/train/checkpoint.py``) as the
    port's parameters; keys and shapes must be the config's."""
    return common.params_from_numpy(
        flat, {k: s for k, (s, _) in param_shapes(cfg).items()},
        name=cfg.name, device=resolve_device(device))


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def mesh_params(params: Params) -> Params:
    """The parameters a RecSys loss reads under a real train mesh, where
    the trainer hands them on as a ``spmd.Joined`` (this process's blocks
    and the shardings they were placed by, ``rules.recsys_specs``): a
    table whose rows the model axis splits stays split (a
    ``spmd.RowBlock``: its block and the whole table's rows, which
    ``embedding_lookup`` looks up row-parallel on any mesh, a
    ``spmd.MetaMesh`` too); a dense weight it splits, and BERT4Rec's
    position table (read by a slice, not a lookup), is joined whole over
    the axis (they are small; the gradient goes back to this process's
    part). Otherwise the parameters as they are."""
    from repro_torch.sharding import rules, spmd
    if not isinstance(params, spmd.Joined):
        return params
    out = {}
    for k in params:
        sh = params.shardings[k]
        split = [d for d, e in enumerate(sh.spec)
                 if "model" in rules._axes(e)]
        if not split:
            out[k] = params[k]
        elif rules.TABLE_PATHS.search(k) and k != "pos":   # looked up
            block = params[k]
            out[k] = spmd.RowBlock(block, sh.mesh, block.shape[0]
                                   * spmd.Axis(sh.mesh, "model").size)
        else:
            out[k] = spmd.tp_gather(params[k], split[0],
                                    spmd.Axis(sh.mesh, "model"))
    return out


def _on_mesh(loss):
    """``loss(params, cfg, batch)`` reading ``mesh_params``."""
    def fn(params, cfg, batch):
        return loss(mesh_params(params), cfg, batch)
    fn.__name__, fn.__doc__ = loss.__name__, loss.__doc__
    return fn


INIT = {"bert4rec": init_bert4rec, "dien": init_dien,
        "wide_deep": init_wide_deep, "dcn_v2": init_dcn_v2}
TRAIN_LOSS = {"bert4rec": _on_mesh(bert4rec_train_loss),
              "dien": _on_mesh(dien_train_loss),
              "wide_deep": _on_mesh(wide_deep_train_loss),
              "dcn_v2": _on_mesh(dcn_v2_train_loss)}
SERVE = {"bert4rec": bert4rec_serve, "dien": dien_serve,
         "wide_deep": wide_deep_serve, "dcn_v2": dcn_v2_serve}
RETRIEVAL = {"bert4rec": bert4rec_retrieval, "dien": dien_retrieval,
             "wide_deep": wide_deep_retrieval, "dcn_v2": dcn_v2_retrieval}

N_MASK = 20           # BERT4Rec masked positions per sequence
N_NEG = 8192          # shared sampled negatives


def make_batch(cfg: RecSysConfig, shape, *, rng_key=0, numpy=False,
               device: Device = None):
    """Random-but-valid input batch for a shape cell: the reference's
    numpy draws in the reference's order, so the same ``rng_key`` gives
    the same arrays bit for bit. Tensors on the device (cuda unless
    ``device`` says otherwise), or the numpy arrays with ``numpy=True``."""
    rng = np.random.default_rng(rng_key)
    B = shape.get("batch", 2)
    k = cfg.kind

    def ids(rows, *shp):
        return rng.integers(0, rows, shp).astype(np.int32)

    if k == "bert4rec":
        V = cfg.tables["item"]
        b = {"items": ids(V, B, cfg.seq_len)}
        if shape.kind == "train":
            b.update(mask_pos=np.sort(ids(cfg.seq_len, B, N_MASK)),
                     targets=ids(V, B, N_MASK), neg_samples=ids(V, N_NEG))
        if shape.kind == "retrieval":
            b["candidates"] = ids(V, shape["n_candidates"])
    elif k == "dien":
        b = {"hist_items": ids(cfg.tables["item"], B, cfg.seq_len),
             "hist_cats": ids(cfg.tables["category"], B, cfg.seq_len),
             "hist_mask": np.ones((B, cfg.seq_len), bool),
             "user": ids(cfg.tables["user"], B),
             "target_item": ids(cfg.tables["item"], B),
             "target_cat": ids(cfg.tables["category"], B)}
        if shape.kind == "train":
            b["label"] = rng.random(B).round().astype(np.float32)
        if shape.kind == "retrieval":
            C = shape["n_candidates"]
            b["candidates"] = ids(cfg.tables["item"], C)
            b["cand_cats"] = ids(cfg.tables["category"], C)
    elif k == "wide_deep":
        onehot = [n for n in sorted(cfg.tables) if n not in cfg.multi_hot]
        b = {"sparse_ids": np.stack(
                [ids(cfg.tables[n], B) for n in onehot], axis=1),
             "bag_ids": {n: ids(cfg.tables[n], B, bag)
                         for n, bag in cfg.multi_hot.items()},
             "wide_ids": ids(N_WIDE_BUCKETS, B, N_WIDE_CROSS)}
        if shape.kind == "train":
            b["label"] = rng.random(B).round().astype(np.float32)
        if shape.kind == "retrieval":
            b["candidates"] = ids(cfg.tables[sorted(cfg.tables)[0]],
                                  shape["n_candidates"])
    elif k == "dcn_v2":
        b = {"dense": rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
             "sparse_ids": np.stack(
                 [ids(cfg.tables[n], B) for n in sorted(cfg.tables)], axis=1)}
        if shape.kind == "train":
            b["label"] = rng.random(B).round().astype(np.float32)
        if shape.kind == "retrieval":
            b["candidates"] = ids(cfg.tables[sorted(cfg.tables)[0]],
                                  shape["n_candidates"])
    else:
        raise ValueError(k)
    if numpy:
        return b
    return to_device(b, device)


def to_device(batch, device: Device = None):
    """A batch of numpy arrays (a dict, possibly nested, or a NamedTuple
    such as ``gnn.Graph``) as tensors on the device."""
    dev = resolve_device(device)
    if isinstance(batch, dict):
        return {k: to_device(v, dev) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return type(batch)(*(to_device(v, dev) for v in batch))
    return torch.from_numpy(np.asarray(batch)).to(dev)
