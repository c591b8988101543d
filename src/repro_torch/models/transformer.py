"""The dense decoder-only LM family (qwen2-1.5b, phi3-mini-3.8b,
deepseek-coder-33b): init, the forward pass, prefill and KV-cache decode.
Counterpart of ``repro/models/transformer.py``.

The model is an ``nn.Module`` whose decoder layers sit in an
``nn.ModuleList``; the reference stacks them on a leading axis for
``lax.scan``, the port walks the list. Weights carry across in the
reference's checkpoint form: a flat dict keyed by path (``embed``,
``layers/attn/wq``, ...) whose ``layers/*`` leaves are stacked over a
leading layer axis (``params_from_numpy``, ``params_to_numpy``). MoE models
raise ``NotImplementedError``.

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
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import Device, resolve_device
from repro_torch.models import layers as L


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dense_only(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE models are not ported "
                                  f"yet (ROADMAP Queue 1, item 18b)")


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LMConfig, dtype: torch.dtype, device, *,
                 attn: Optional[L.Attention] = None,
                 mlp: Optional[L.MLP] = None):
        super().__init__()
        self.ln1 = L._param((cfg.d_model,), torch.float32, device, fill=1.0)
        self.ln2 = L._param((cfg.d_model,), torch.float32, device, fill=1.0)
        self.attn = attn if attn is not None else L.Attention(cfg, dtype,
                                                              device)
        self.mlp = mlp if mlp is not None else L.MLP(cfg.d_model, cfg.d_ff,
                                                     dtype, device)


class LM(nn.Module):
    """A dense LM: ``init_lm`` draws its weights, ``params_from_numpy``
    loads them. ``layers=None`` allocates ``cfg.n_layers`` layers of
    uninitialised weights."""

    def __init__(self, cfg: LMConfig, device: Device = None, *,
                 layers: Optional[Iterable[DecoderLayer]] = None):
        super().__init__()
        _dense_only(cfg)
        dev = resolve_device(device)
        dt = _dtype(cfg)
        self.cfg = cfg
        self.embed = L._param((cfg.vocab_size, cfg.d_model), dt, dev)
        self.final_norm = L._param((cfg.d_model,), torch.float32, dev,
                                   fill=1.0)
        if layers is None:
            layers = (DecoderLayer(cfg, dt, dev)
                      for _ in range(cfg.n_layers))
        self.layers = nn.ModuleList(layers)
        self.lm_head = (None if cfg.tie_embeddings else
                        L._param((cfg.d_model, cfg.vocab_size), dt, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_lm(cfg: LMConfig, *, seed: int = 0, device: Device = None) -> LM:
    """The reference's shapes, dtypes and scales: N(0, 1/d) embeddings and
    projections (``w_down`` N(0, 1/d_ff)), ones for the norms, zeros for the
    biases, drawn in the order embed, layers, lm_head from a
    ``torch.Generator`` on the model's device seeded with ``seed`` (so one
    seed gives other weights on the card than on the CPU). Runs on cuda
    unless ``device`` says otherwise."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    with torch.no_grad():
        model = LM(cfg, dev, layers=())
        model.embed.normal_(0.0, d ** -0.5, generator=gen)
        for _ in range(cfg.n_layers):
            model.layers.append(DecoderLayer(
                cfg, dt, dev, attn=L.init_attn(gen, cfg, dt, dev),
                mlp=L.init_mlp(gen, d, cfg.d_ff, dt, dev)))
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

_ATTN = ("wq", "wk", "wv", "wo")
_BIAS = ("bq", "bk", "bv")
_MLP = ("w_gate", "w_up", "w_down")


def _leaves(model: LM) -> Dict[str, list]:
    """{checkpoint key: [tensor]}: one tensor for a global leaf, one per
    layer (in order) for a ``layers/*`` leaf."""
    cfg = model.cfg
    out = {"embed": [model.embed], "final_norm": [model.final_norm]}
    if model.lm_head is not None:
        out["lm_head"] = [model.lm_head]
    ls = list(model.layers)
    out["layers/ln1"] = [layer.ln1 for layer in ls]
    out["layers/ln2"] = [layer.ln2 for layer in ls]
    for n in _ATTN + (_BIAS if cfg.qkv_bias else ()):
        out[f"layers/attn/{n}"] = [getattr(layer.attn, n) for layer in ls]
    for n in _MLP:
        out[f"layers/mlp/{n}"] = [getattr(layer.mlp, n) for layer in ls]
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


def _layer(layer: DecoderLayer, cfg: LMConfig, x, positions,
           cache: Optional[L.KVCache] = None):
    """One decoder layer over the whole sequence: (x', the sequence's k and
    v in ``cache``'s dtype, or None without a cache)."""
    h, kv = L.attn_block(layer.attn, cfg, L.rms_norm(x, layer.ln1,
                                                     cfg.norm_eps),
                         positions=positions, cache=cache)
    x = x + h
    x = x + L.mlp_block(layer.mlp, L.rms_norm(x, layer.ln2, cfg.norm_eps))
    return x, kv


@torch.inference_mode()
def forward(model: LM,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (hidden (B, S, d), aux_loss 0: no MoE)."""
    cfg = model.cfg
    B, S = tokens.shape
    x = model.embed[tokens]
    positions = _positions(B, S, x.device)
    for layer in model.layers:
        x, _ = _layer(layer, cfg, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rms_norm(x, model.final_norm, cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# Training: the forward with gradients, over stacked tensors
# ---------------------------------------------------------------------------

Params = Dict[str, torch.Tensor]


def _layer_views(params: Params, n_layers: int) -> List[SimpleNamespace]:
    """Each layer's slices of the stacked ``layers/*`` tensors, laid out
    as a ``DecoderLayer`` (``layer.attn.wq``, ...), so ``_layer`` runs on
    them."""
    per = {k[len("layers/"):]: params[k].unbind(0) for k in params
           if k.startswith("layers/")}
    out = []
    for i in range(n_layers):
        layer = SimpleNamespace(attn=SimpleNamespace(),
                                mlp=SimpleNamespace())
        for name, ts in per.items():
            *path, leaf = name.split("/")
            obj = layer
            for part in path:
                obj = getattr(obj, part)
            setattr(obj, leaf, ts[i])
        out.append(layer)
    return out


def _layer_out(layer, cfg: LMConfig, x, positions):
    return _layer(layer, cfg, x, positions)[0]


def train_forward(params: Params, cfg: LMConfig, tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (hidden (B, S, d), aux_loss 0: no MoE), with
    gradients, from weights in ``stack_params``' form. The embedding is
    ``F.embedding``, whose backward is deterministic on the card (the
    indexing form's is an accumulating ``index_put``). With ``cfg.remat``
    each decoder layer keeps only its input for the backward and is run
    again there."""
    _dense_only(cfg)
    B, S = tokens.shape
    x = F.embedding(tokens, params["embed"])
    positions = _positions(B, S, x.device)
    for layer in _layer_views(params, cfg.n_layers):
        if cfg.remat:
            x = checkpoint(_layer_out, layer, cfg, x, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer_out(layer, cfg, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def lm_loss(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """The mean next-token cross-entropy (f32) of ``labels`` given
    ``tokens``, both (B, S); the reference's ``n_groups`` and
    ``causal_skip`` change nothing for a dense model and are not taken."""
    hidden, aux = train_forward(params, cfg, tokens)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return L.chunked_softmax_xent(hidden, head, labels) + aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

class LMCache(NamedTuple):
    prefix_k: Optional[torch.Tensor]   # MoE first_k_dense layers: None here
    prefix_v: Optional[torch.Tensor]
    main_k: torch.Tensor               # (L, B, Hkv, S, hd)
    main_v: torch.Tensor
    length: torch.Tensor               # (B,) int32


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, *,
               device: Device = None) -> LMCache:
    _dense_only(cfg)
    dev = resolve_device(device)
    shp = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dt = dtype or _dtype(cfg)
    return LMCache(None, None, torch.zeros(shp, dtype=dt, device=dev),
                   torch.zeros(shp, dtype=dt, device=dev),
                   torch.zeros((batch,), dtype=torch.int32, device=dev))


@torch.inference_mode()
def decode_step(model: LM, tokens: torch.Tensor,
                cache: LMCache) -> Tuple[torch.Tensor, LMCache]:
    """tokens (B, 1) -> (logits (B, 1, V) f32, cache). One new token against
    a KV cache of ``max_len`` slots (``cache.length`` valid); its k and v
    are written IN PLACE into the cache's tensors."""
    cfg = model.cfg
    x = model.embed[tokens]
    for i, layer in enumerate(model.layers):
        kv = L.KVCache(cache.main_k[i], cache.main_v[i], cache.length)
        h, _ = L.attn_decode_block(layer.attn, cfg,
                                   L.rms_norm(x, layer.ln1, cfg.norm_eps), kv)
        x = x + h
        x = x + L.mlp_block(layer.mlp, L.rms_norm(x, layer.ln2, cfg.norm_eps))
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = (x @ lm_head_weight(model)).float()
    return logits, LMCache(None, None, cache.main_k, cache.main_v,
                           cache.length + 1)


@torch.inference_mode()
def prefill_step(model: LM, tokens: torch.Tensor, *,
                 max_len: Optional[int] = None
                 ) -> Tuple[torch.Tensor, LMCache]:
    """Full-sequence prefill: (last-position logits (B, 1, V) f32, cache).
    The cache has ``max_len`` slots (S by default) and holds the prompt's k
    and v in its first S, as the reference's cache padded to ``max_len``."""
    cfg = model.cfg
    B, S = tokens.shape
    max_len = S if max_len is None else max_len
    if max_len < S:
        raise ValueError(f"prefill_step: max_len {max_len} < prompt {S}")
    cache = init_cache(cfg, B, max_len, device=model.device)
    x = model.embed[tokens]
    positions = _positions(B, S, x.device)
    for i, layer in enumerate(model.layers):
        x, kv = _layer(layer, cfg, x, positions,
                       L.KVCache(cache.main_k[i], cache.main_v[i],
                                 cache.length))
        cache.main_k[i, :, :, :S] = kv.k
        cache.main_v[i, :, :, :S] = kv.v
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = (x[:, -1:] @ lm_head_weight(model)).float()
    length = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, cache._replace(length=length)
