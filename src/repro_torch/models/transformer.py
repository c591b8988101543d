"""The decoder-only LM family, dense (qwen2-1.5b, phi3-mini-3.8b,
deepseek-coder-33b) and MoE (deepseek-moe-16b: shared experts and a
first-k-dense prefix; arctic-480b: a dense residual beside the experts):
init, the forward pass, prefill and KV-cache decode. Counterpart of
``repro/models/transformer.py``.

The model is an ``nn.Module`` whose decoder layers sit in two
``nn.ModuleList``s: ``prefix``, an MoE model's ``first_k_dense`` dense
layers (empty otherwise), and ``layers``, the rest (MoE layers in an MoE
model); the reference stacks ``layers`` on a leading axis for ``lax.scan``,
the port walks the lists. Weights carry across in the reference's
checkpoint form: a flat dict keyed by path (``embed``, ``layers/attn/wq``,
``layers/moe/shared/w_gate``, ``prefix/0/mlp/w_up``, ...) whose
``layers/*`` leaves are stacked over a leading layer axis and whose
``prefix/<i>/*`` leaves are one layer's each, the reference's list
flattened by index (``params_from_numpy``, ``params_to_numpy``).

Serving (``forward``, ``prefill_step``, ``decode_step``) runs the module
under ``torch.inference_mode()``. Training (``train_forward``, ``lm_loss``)
is functional over that checkpoint form as tensors (``stack_params``): the
trainer makes them leaves that require grad, each layer reads its slice
(``unbind``, whose backward stacks the layers' gradients once), and
``cfg.remat`` recomputes each decoder layer in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint(body)``.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import Device, resolve_device
from repro_torch.models import layers as L
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import constrain


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def n_prefix(cfg: LMConfig) -> int:
    """The leading dense layers of an MoE model (0 for a dense one)."""
    return cfg.first_k_dense if cfg.moe is not None else 0


class DecoderLayer(nn.Module):
    """Norms, attention and either a dense ``mlp`` or an ``moe``, of
    uninitialised weights."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype, device, *,
                 moe: bool = False):
        super().__init__()
        self.ln1 = L._param((cfg.d_model,), torch.float32, device, fill=1.0)
        self.ln2 = L._param((cfg.d_model,), torch.float32, device, fill=1.0)
        self.attn = L.Attention(cfg, dtype, device)
        if moe:
            self.moe = L.MoE(cfg, dtype, device)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dtype, device)


class LM(nn.Module):
    """An LM of uninitialised weights: ``init_lm`` draws them,
    ``params_from_numpy`` loads them."""

    def __init__(self, cfg: LMConfig, device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        dt = _dtype(cfg)
        self.cfg = cfg
        self.embed = L._param((cfg.vocab_size, cfg.d_model), dt, dev)
        self.final_norm = L._param((cfg.d_model,), torch.float32, dev,
                                   fill=1.0)
        P = n_prefix(cfg)
        self.prefix = nn.ModuleList(DecoderLayer(cfg, dt, dev)
                                    for _ in range(P))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dt, dev, moe=cfg.moe is not None)
            for _ in range(cfg.n_layers - P))
        self.lm_head = (None if cfg.tie_embeddings else
                        L._param((cfg.d_model, cfg.vocab_size), dt, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_lm(cfg: LMConfig, *, seed: int = 0, device: Device = None) -> LM:
    """The reference's shapes, dtypes and scales: N(0, 1/d) embeddings,
    projections and routers (``w_down`` N(0, 1/d_ff), an expert's
    N(0, 1/f_e)), ones for the norms, zeros for the biases, drawn from one
    ``torch.Generator`` on the model's device seeded with ``seed`` (so one
    seed gives other weights on the card than on the CPU) in the order
    embed, the prefix layers, the main layers (each: attention, then its
    MLP or MoE), lm_head. Runs on cuda unless ``device`` says otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    with torch.no_grad():
        model = LM(cfg, dev)
        model.embed.normal_(0.0, d ** -0.5, generator=gen)
        for layer in (*model.prefix, *model.layers):
            L.draw_attn(layer.attn, gen)
            if hasattr(layer, "moe"):
                L.draw_moe(layer.moe, gen)
            else:
                L.draw_mlp(layer.mlp, gen)
        if model.lm_head is not None:
            model.lm_head.normal_(0.0, d ** -0.5, generator=gen)
    return model


def lm_head_weight(model: LM) -> torch.Tensor:
    if model.lm_head is not None:
        return model.lm_head
    return model.embed.T   # tied embeddings


# ---------------------------------------------------------------------------
# Weights in the reference's checkpoint form
# ---------------------------------------------------------------------------

def _leaves(model: LM) -> Dict[str, list]:
    """{checkpoint key: [tensor]}: one tensor for a global leaf or a
    ``prefix/<i>/*`` leaf, one per layer (in order) for a ``layers/*``
    leaf. A layer's leaves are its parameters by name (``attn.wq`` ->
    ``attn/wq``, ``moe.shared.w_up`` -> ``moe/shared/w_up``)."""
    out = {"embed": [model.embed], "final_norm": [model.final_norm]}
    if model.lm_head is not None:
        out["lm_head"] = [model.lm_head]
    for i, layer in enumerate(model.prefix):
        for name, t in layer.named_parameters():
            out[f"prefix/{i}/{name.replace('.', '/')}"] = [t]
    for layer in model.layers:
        for name, t in layer.named_parameters():
            out.setdefault(f"layers/{name.replace('.', '/')}", []).append(t)
    return out


def _from_numpy(a: np.ndarray, dtype: torch.dtype, key: str) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of ``dtype``, without loss. NumPy has no
    bf16: a bf16 leaf arrives as JAX's ``ml_dtypes.bfloat16`` (kind 'V'),
    as the void it becomes in an ``.npz``, or as its uint16 bits."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        if a.dtype.itemsize != 2 or a.dtype.kind not in "Vui":
            raise TypeError(f"{key}: want bfloat16 bits, got {a.dtype}")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype != np.dtype(str(dtype).split(".")[-1]):
        raise TypeError(f"{key}: want {dtype}, got {a.dtype}")
    return torch.from_numpy(a.copy())


def params_from_numpy(cfg: LMConfig, flat: Dict[str, np.ndarray], *,
                      device: Device = None) -> LM:
    """An LM holding the weights of a flat, path-keyed dict in the
    reference's checkpoint form (``repro/train/checkpoint.py``; what
    ``repro_torch.train.checkpoint.load`` returns for an LM checkpoint).
    The ``layers/*`` leaves are split per layer. Keys, shapes and dtypes
    must match the config exactly."""
    model = LM(cfg, device)
    want = _leaves(model)
    if set(flat) != set(want):
        raise KeyError(f"{cfg.name}: checkpoint keys differ: missing "
                       f"{sorted(set(want) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(want))}")
    with torch.no_grad():
        for key, dst in want.items():
            src = _from_numpy(flat[key], dst[0].dtype, key)
            stacked = key.startswith("layers/")
            shape = ((len(dst),) if stacked else ()) + tuple(dst[0].shape)
            if tuple(src.shape) != shape:
                raise ValueError(f"{key}: want {shape}, got "
                                 f"{tuple(src.shape)}")
            for i, t in enumerate(dst):
                t.copy_(src[i] if stacked else src)
    return model


def stack_params(model: LM) -> Dict[str, torch.Tensor]:
    """The model's weights as new tensors in the reference's checkpoint
    form, on the model's device: a flat dict keyed by path whose
    ``layers/*`` leaves are stacked over a leading layer axis. What
    ``lm_loss`` and the optimizers take."""
    return {key: torch.stack([x.detach() for x in ts])
            if key.startswith("layers/") else ts[0].detach().clone()
            for key, ts in _leaves(model).items()}


def params_to_numpy(model: LM) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``: ``stack_params`` on the host;
    bf16 leaves as their uint16 bits (``a.view(ml_dtypes.bfloat16)``
    gives JAX's dtype back)."""
    out = {}
    for key, t in stack_params(model).items():
        t = t.cpu()
        out[key] = (t.view(torch.int16).numpy().view(np.uint16)
                    if t.dtype == torch.bfloat16 else t.numpy())
    return out


# ---------------------------------------------------------------------------
# Forward (prefill anchor)
# ---------------------------------------------------------------------------

def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.float32, device=device)[None].expand(
        B, S)


def _ffn(layer, cfg: LMConfig, z: torch.Tensor, rows=None):
    """The layer's MLP or MoE on the normed ``z``: (out, aux), aux None
    for a dense layer (the reference adds a zero, which changes no sum).
    ``rows``: on a serving mesh, the data axes that split z's rows."""
    if hasattr(layer, "moe"):
        return L.moe_block(layer.moe, cfg, z, rows=rows)
    return L.mlp_block(layer.mlp, z, width=cfg.d_ff), None


def _layer(layer: DecoderLayer, cfg: LMConfig, x, positions,
           cache: Optional[L.KVCache] = None, rows=None):
    """One decoder layer over the whole sequence: (x', the sequence's k and
    v in ``cache``'s dtype, or None without a cache, the MoE aux loss or
    None)."""
    h, kv = L.attn_block(layer.attn, cfg, L.rms_norm(x, layer.ln1,
                                                     cfg.norm_eps),
                         positions=positions, cache=cache)
    x = x + h
    mo, aux = _ffn(layer, cfg, L.rms_norm(x, layer.ln2, cfg.norm_eps), rows)
    return x + mo, kv, aux


@torch.inference_mode()
def forward(model: LM,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (hidden (B, S, d), aux_loss): the aux losses added
    in the reference's order, the prefix layers' zeros first."""
    cfg = model.cfg
    B, S = tokens.shape
    x = model.embed[tokens]
    positions = _positions(B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in (*model.prefix, *model.layers):
        x, _, a = _layer(layer, cfg, x, positions)
        aux = aux if a is None else aux + a
    return L.rms_norm(x, model.final_norm, cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# Training: the forward with gradients, over stacked tensors
# ---------------------------------------------------------------------------

Params = Dict[str, torch.Tensor]


def _view(leaves: Dict[str, torch.Tensor]) -> SimpleNamespace:
    """Path-keyed tensors (``attn/wq``, ``moe/shared/w_up``) as nested
    namespaces laid out as a ``DecoderLayer`` (``layer.attn.wq``,
    ``layer.moe.shared.w_up``), so ``_layer`` runs on them."""
    root = SimpleNamespace()
    for name, t in leaves.items():
        *path, leaf = name.split("/")
        obj = root
        for part in path:
            if not hasattr(obj, part):
                setattr(obj, part, SimpleNamespace())
            obj = getattr(obj, part)
        setattr(obj, leaf, t)
    return root


def _layer_views(params: Params, cfg: LMConfig
                 ) -> Tuple[List[Dict], List[Dict]]:
    """(the prefix layers, the main layers), each a dict of its leaves by
    path within the layer: a prefix layer its ``prefix/<i>/*`` leaves, a
    main layer its slices of the stacked ``layers/*`` leaves. On a train
    mesh (``params`` a ``spmd.Joined``) the leaves are this process's
    blocks, which ``_layer_out`` joins."""
    P = n_prefix(cfg)
    prefix = [{k[len(f"prefix/{i}/"):]: spmd.lazy(params, k) for k in params
               if k.startswith(f"prefix/{i}/")} for i in range(P)]
    per = {k[len("layers/"):]: spmd.lazy_layers(params, k) for k in params
           if k.startswith("layers/")}
    main = [{name: ts[i] for name, ts in per.items()}
            for i in range(cfg.n_layers - P)]
    return prefix, main


def _layer_out(leaves: Dict, cfg: LMConfig, x, positions):
    layer = _view({name: spmd.joined(t) for name, t in leaves.items()})
    x, _, aux = _layer(layer, cfg, x, positions)
    return x, aux


def train_forward(params: Params, cfg: LMConfig, tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (hidden (B, S, d), aux_loss), with gradients, from
    weights in ``stack_params``' form. The embedding is ``F.embedding``
    (``layers.embed_tokens``; vocabulary-parallel under a train mesh),
    whose backward is deterministic on the card (the indexing form's is an
    accumulating ``index_put``). With ``cfg.remat`` each main layer keeps
    only its input for the backward and is run again there (the prefix
    layers are not, as in the reference). The aux losses are added in the
    reference's order; the reference's ``constrain`` calls stand at its
    places. Under a train mesh the weights are this process's model parts
    and ``tokens`` its data rows (``train.trainer``): each layer's blocks
    are joined over the data axes inside it and released after it
    (``spmd.released``)."""
    B, S = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, cfg.vocab_size)
    x = constrain(x, "dp", None, None)
    positions = _positions(B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    prefix, main = _layer_views(params, cfg)
    for i, layer in enumerate(prefix + main):
        if i >= len(prefix):
            x = constrain(x, "dp", None, None)
        with spmd.released():
            if cfg.remat and i >= len(prefix):
                x, a = checkpoint(_layer_out, layer, cfg, x, positions,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = _layer_out(layer, cfg, x, positions)
        if i >= len(prefix):
            x = constrain(x, "dp", None, None)
        aux = aux if a is None else aux + a
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def lm_loss(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """The mean next-token cross-entropy (f32) of ``labels`` given
    ``tokens``, both (B, S), plus the MoE aux loss; the reference's
    ``n_groups`` and ``causal_skip`` change no result and are not
    taken."""
    hidden, aux = train_forward(params, cfg, tokens)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return L.chunked_softmax_xent(hidden, head, labels,
                                  vocab=cfg.vocab_size) + aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

class LMCache(NamedTuple):
    prefix_k: Optional[torch.Tensor]   # (P, B, Hkv, S, hd), or None (P = 0)
    prefix_v: Optional[torch.Tensor]
    main_k: torch.Tensor               # (L', B, Hkv, S, hd)
    main_v: torch.Tensor
    length: torch.Tensor               # (B,) int32


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, *,
               device: Device = None) -> LMCache:
    dev = resolve_device(device)
    dt = dtype or _dtype(cfg)
    P = n_prefix(cfg)
    shp = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)

    def zeros(n):
        return torch.zeros((n,) + shp, dtype=dt, device=dev)
    pk, pv = (zeros(P), zeros(P)) if P else (None, None)
    return LMCache(pk, pv, zeros(cfg.n_layers - P), zeros(cfg.n_layers - P),
                   torch.zeros((batch,), dtype=torch.int32, device=dev))


def _with_caches(model: LM, cache: LMCache):
    """(layer, its k cache, its v cache) for the prefix layers, then the
    main layers."""
    out = []
    if model.prefix:
        out += zip(model.prefix, cache.prefix_k, cache.prefix_v)
    return out + list(zip(model.layers, cache.main_k, cache.main_v))


# ---------------------------------------------------------------------------
# Serving on a (data, model) mesh, one process a card
# ---------------------------------------------------------------------------

class ServeLayout(NamedTuple):
    """Where a serving cell's rows and cache live on its mesh: the data
    axes that split the batch's rows (and the tokens' and the cache's),
    and the axes that split the cache's sequence, each major first
    (``rules.cache_specs``' choice for the batch)."""
    rows: Tuple[str, ...]
    seq: Tuple[str, ...]


def serve_layout(mesh, cfg: LMConfig, batch: int,
                 max_len: int) -> ServeLayout:
    """The layout of a decode cell's cache of ``batch`` rows and
    ``max_len`` slots on ``mesh`` (a ``DeviceMesh``, a ``MetaMesh`` or a
    shape), which a prefill's cache takes so that decode carries on from
    it: the reference's ``_lm_cell`` specs, guarded."""
    from repro_torch.sharding import rules
    shp = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    spec = rules.cache_specs(LMCache(None, None, shp, shp, (batch,)), mesh,
                             batch).main_k.spec
    return ServeLayout(rules._axes(spec[1]), rules._axes(spec[3]))


def _serve_mesh():
    from repro_torch.sharding import rules
    mesh = rules.active_device_mesh()
    if mesh is None:
        raise ValueError("serving placed parameters needs an active mesh "
                         "(rules.activation_mesh of a DeviceMesh or a "
                         "MetaMesh)")
    return mesh


def _segment(mesh, names) -> Tuple[tuple, int]:
    """The ``spmd.Axis``es of ``names`` and this process's index in their
    product (major first)."""
    axes = tuple(spmd.Axis(mesh, a) for a in names)
    g = 0
    for a in axes:
        g = g * a.size + a.index
    return axes, g


def _logits(params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """The head's f32 logits of ``x``: on a mesh whose model axis splits
    the vocabulary, this process's columns, joined over the axis."""
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    logits = (x @ head).float()
    tp = spmd.tp_axis()
    if L._split(cfg.vocab_size, tp):
        logits = spmd.tp_gather(logits, -1, tp)
    return logits


def _cache_block(t: torch.Tensor, cfg: LMConfig, max_len: int,
                 layout: ServeLayout, mesh) -> torch.Tensor:
    """A prefill layer's k or v, t (B_l, H, S, hd) of this process's rows
    (its heads when the model axis splits them), as this process's block
    of the decode cell's cache: (B_l, Hkv, S_l, hd), slots past S zero.
    Heads split over the model axis become a sequence split by one
    all-to-all over it (``spmd.heads_to_sequence``) when "model" is the
    last axis that splits the sequence, the data axes' part of the
    sequence taken first; otherwise the heads are joined and each process
    slices its segment."""
    B, H, S, hd = t.shape
    if S < max_len:
        t = torch.nn.functional.pad(t, (0, 0, 0, max_len - S))
    axes, g = _segment(mesh, layout.seq)
    tp = spmd.tp_axis()
    if H < cfg.n_kv_heads:
        if axes and axes[-1].name == tp.name:
            outer, g_out = _segment(mesh, layout.seq[:-1])
            n = 1
            for a in outer:
                n *= a.size
            part = max_len // n
            t = t[:, :, g_out * part:(g_out + 1) * part]
            return spmd.heads_to_sequence(t, tp).contiguous()
        t = spmd.tp_gather(t, 1, tp)
    n = 1
    for a in axes:
        n *= a.size
    part = max_len // n
    return t[:, :, g * part:(g + 1) * part].contiguous()


def _serve_layer(leaves, cfg: LMConfig, x, positions, kv, rows):
    """One prefill layer on the mesh, its parameters joined over the data
    axes inside it: (x', k, v)."""
    layer = _view({name: spmd.joined(t) for name, t in leaves.items()})
    x, kv, _ = _layer(layer, cfg, x, positions, kv, rows)
    return x, kv.k, kv.v


def _decode_layer(leaves, cfg: LMConfig, x, kv: L.KVCache, seq, rows):
    layer = _view({name: spmd.joined(t) for name, t in leaves.items()})
    h, _ = L.attn_decode_block(layer.attn, cfg,
                               L.rms_norm(x, layer.ln1, cfg.norm_eps), kv,
                               seq)
    x = x + h
    return x + _ffn(layer, cfg, L.rms_norm(x, layer.ln2, cfg.norm_eps),
                    rows)[0]


def _prefill_mesh(params, cfg: LMConfig, tokens: torch.Tensor, max_len: int,
                  layout: ServeLayout) -> Tuple[torch.Tensor, LMCache]:
    mesh = _serve_mesh()
    rows, _ = _segment(mesh, layout.rows)
    B, S = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, cfg.vocab_size)
    positions = _positions(B, S, x.device)
    prefix, main = _layer_views(params, cfg)
    seq, _ = _segment(mesh, layout.seq)
    n = 1
    for a in seq:
        n *= a.size
    dt = _dtype(cfg)
    shp = (B, cfg.n_kv_heads, max_len // n, cfg.head_dim)

    def zeros(k):
        return torch.zeros((k,) + shp, dtype=dt, device=x.device)
    P = len(prefix)
    pk, pv = (zeros(P), zeros(P)) if P else (None, None)
    mk, mv = zeros(len(main)), zeros(len(main))
    slots = ([(pk[i], pv[i]) for i in range(P)]
             + [(mk[i], mv[i]) for i in range(len(main))])
    for leaves, (k, v) in zip(prefix + main, slots):
        x, lk, lv = _serve_layer(leaves, cfg, x, positions,
                                 L.KVCache(k, v, None), rows)
        k.copy_(_cache_block(lk, cfg, max_len, layout, mesh))
        v.copy_(_cache_block(lv, cfg, max_len, layout, mesh))
        del lk, lv
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1:])
    length = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, LMCache(pk, pv, mk, mv, length)


def _decode_mesh(params, cfg: LMConfig, tokens: torch.Tensor,
                 cache: LMCache, layout: ServeLayout
                 ) -> Tuple[torch.Tensor, LMCache]:
    mesh = _serve_mesh()
    rows, _ = _segment(mesh, layout.rows)
    seq = L.SeqSplit(*_segment(mesh, layout.seq))
    x = L.embed_tokens(params["embed"], tokens, cfg.vocab_size)
    prefix, main = _layer_views(params, cfg)
    ks = list(cache.main_k) if cache.prefix_k is None else \
        list(cache.prefix_k) + list(cache.main_k)
    vs = list(cache.main_v) if cache.prefix_v is None else \
        list(cache.prefix_v) + list(cache.main_v)
    for leaves, k, v in zip(prefix + main, ks, vs):
        x = _decode_layer(leaves, cfg, x, L.KVCache(k, v, cache.length),
                          seq, rows)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x), cache._replace(length=cache.length + 1)


@torch.inference_mode()
def decode_step(model: LM, tokens: torch.Tensor, cache: LMCache, *,
                cfg: Optional[LMConfig] = None,
                layout: Optional[ServeLayout] = None
                ) -> Tuple[torch.Tensor, LMCache]:
    """tokens (B, 1) -> (logits (B, 1, V) f32, cache). One new token against
    a KV cache of ``max_len`` slots (``cache.length`` valid); its k and v
    are written IN PLACE into the cache's tensors.

    On a serving mesh (``model`` a ``spmd.Joined`` of this process's
    parameter blocks placed by ``rules.lm_specs``, under
    ``rules.activation_mesh`` of the mesh; ``cfg`` and ``layout``, the
    cache's ``serve_layout``, given) ``tokens`` and ``cache`` are this
    process's blocks: each layer's blocks are joined over the data axes
    inside it, the projections and the MLP are tensor-parallel, each
    process attends over its segment of the cache and the segments are
    merged (``layers.attn_decode_block``), an MoE routes the step's
    tokens as the reference does, and the logits are this process's rows
    over the whole vocabulary."""
    if isinstance(model, spmd.Joined):
        return _decode_mesh(model, cfg, tokens, cache, layout)
    cfg = model.cfg
    x = model.embed[tokens]
    for layer, k, v in _with_caches(model, cache):
        kv = L.KVCache(k, v, cache.length)
        h, _ = L.attn_decode_block(layer.attn, cfg,
                                   L.rms_norm(x, layer.ln1, cfg.norm_eps), kv)
        x = x + h
        x = x + _ffn(layer, cfg, L.rms_norm(x, layer.ln2, cfg.norm_eps))[0]
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = (x @ lm_head_weight(model)).float()
    return logits, cache._replace(length=cache.length + 1)


@torch.inference_mode()
def prefill_step(model: LM, tokens: torch.Tensor, *,
                 max_len: Optional[int] = None,
                 cfg: Optional[LMConfig] = None,
                 layout: Optional[ServeLayout] = None
                 ) -> Tuple[torch.Tensor, LMCache]:
    """Full-sequence prefill: (last-position logits (B, 1, V) f32, cache).
    The cache has ``max_len`` slots (S by default) and holds the prompt's k
    and v in its first S, as the reference's cache padded to ``max_len``.

    On a serving mesh (``model`` a ``spmd.Joined``, ``cfg`` and ``layout``
    given, as ``decode_step`` takes them) ``tokens`` are this process's
    rows, each process attends with its own heads (``flash_attention``),
    and the cache comes out as this process's block in ``layout``, the
    decode cell's."""
    S = tokens.shape[1]
    max_len = S if max_len is None else max_len
    if max_len < S:
        raise ValueError(f"prefill_step: max_len {max_len} < prompt {S}")
    if isinstance(model, spmd.Joined):
        return _prefill_mesh(model, cfg, tokens, max_len, layout)
    cfg = model.cfg
    B = tokens.shape[0]
    cache = init_cache(cfg, B, max_len, device=model.device)
    x = model.embed[tokens]
    positions = _positions(B, S, x.device)
    for layer, k, v in _with_caches(model, cache):
        x, kv, _ = _layer(layer, cfg, x, positions,
                          L.KVCache(k, v, cache.length))
        k[:, :, :S] = kv.k
        v[:, :, :S] = kv.v
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = (x[:, -1:] @ lm_head_weight(model)).float()
    length = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, cache._replace(length=length)
