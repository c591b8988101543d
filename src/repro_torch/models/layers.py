"""Transformer building blocks of the dense LM family: RMSNorm, RoPE,
attention (prefill and training through the ``flash_attention`` kernel,
one-token decode against a KV cache), the SwiGLU MLP and the chunked
cross-entropy. Counterpart of the dense part of ``repro/models/layers.py``.

Weights keep the reference's layout (``x @ w`` with ``w`` of shape
``(d_in, d_out)``), so they carry across by name
(``transformer.params_from_numpy``). The reference's ``constrain`` and
``opt_barrier`` place data on a mesh and steer XLA; on one card they do
nothing and are dropped. MoE layers are not ported yet (``moe_block``
raises).

Prefill attention on the CPU, in f32 and at the small bf16 head dims keeps
``p`` and the scaled q in f32, as the TPU kernel does; the reference's
``chunked_attention`` rounds both to bf16 in a bf16 model, so bf16 results
differ from it by that rounding (ROADMAP Queue 3). On the card's bf16 route
(head dims 64, 96, 128: ``flash_attention_tc``) ``p`` is rounded to bf16 for
p·v, as the reference's ``chunked_attention`` rounds it; q is not rounded
after scaling (the scale is applied to the f32 scores).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.flash_attention import ops as FA

NEG_INF = -1e30


def _param(shape, dtype, device, fill: Optional[float] = None
           ) -> nn.Parameter:
    """A parameter without gradient (the serving model's; training takes
    its weights as the stacked tensors of ``transformer.stack_params``):
    uninitialised, or ``fill``ed."""
    t = (torch.empty(shape, dtype=dtype, device=device) if fill is None else
         torch.full(shape, fill, dtype=dtype, device=device))
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Norm + RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, head_dim); positions: broadcastable to (..., S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * inv
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool) -> torch.Tensor:
    """q (B, Hq, Sq, hd); k, v (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd) in
    q.dtype, through ``flash_attention.ops.attention`` (online softmax,
    GQA by index, never an (Sq, Skv) tensor). The reference's ``q_offset``
    and ``kv_valid`` are used nowhere in the repo and are not taken; its
    ``causal_skip`` and chunk sizes change no result, and the kernel always
    skips the KV tiles wholly above the diagonal."""
    return FA.attention(q, k, v, causal=causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """One query token against the cache: q (B, Hq, 1, hd), caches
    (B, Hkv, S, hd), ``cache_len`` (B,) valid slots. Linear in S; the
    scores and the softmax are f32, as the reference's
    ``preferred_element_type`` makes them."""
    B, Hq, _, hd = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    qg = (q / math.sqrt(hd)).reshape(B, Hkv, group, hd)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float())
    valid = torch.arange(S, device=q.device)[None, :] < cache_len.reshape(-1, 1)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", (p / l).to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Hq, 1, hd).to(v_cache.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, Hkv, S, hd)
    v: torch.Tensor          # (B, Hkv, S, hd)
    length: torch.Tensor     # (B,) int32 — valid prefix length


class Attention(nn.Module):
    """The attention projections, in the reference's (d_in, d_out) layout."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        self.wq = _param((d, cfg.n_heads * hd), dtype, device)
        self.wk = _param((d, cfg.n_kv_heads * hd), dtype, device)
        self.wv = _param((d, cfg.n_kv_heads * hd), dtype, device)
        self.wo = _param((cfg.n_heads * hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((cfg.n_heads * hd,), dtype, device, fill=0.0)
            self.bk = _param((cfg.n_kv_heads * hd,), dtype, device, fill=0.0)
            self.bv = _param((cfg.n_kv_heads * hd,), dtype, device, fill=0.0)


def init_attn(gen: torch.Generator, cfg: LMConfig, dtype: torch.dtype,
              device) -> Attention:
    """N(0, 1/d) projections, zero biases, drawn from ``gen``."""
    p = Attention(cfg, dtype, device)
    std = cfg.d_model ** -0.5
    for w in (p.wq, p.wk, p.wv, p.wo):
        w.normal_(0.0, std, generator=gen)
    return p


def _project_qkv(p: Attention, cfg: LMConfig, x: torch.Tensor):
    """x (B, S, d) -> q (B, Hq, S, hd), k, v (B, Hkv, S, hd): views of
    (B, S, H, hd) projections, transposed, not copied."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.view(B, S, cfg.n_heads, hd).transpose(1, 2)
    k = k.view(B, S, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.view(B, S, cfg.n_kv_heads, hd).transpose(1, 2)
    return q, k, v


def attn_block(p: Attention, cfg: LMConfig, x: torch.Tensor, *,
               positions: torch.Tensor, cache: Optional[KVCache] = None):
    """Full-sequence attention (prefill). Returns (out, new_cache); the
    cache, when given, receives this sequence's k and v."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=True)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    new_cache = None
    if cache is not None:
        new_cache = KVCache(k=k.to(cache.k.dtype), v=v.to(cache.v.dtype),
                            length=torch.full((B,), S, dtype=torch.int32,
                                              device=x.device))
    return out @ p.wo, new_cache


def attn_decode_block(p: Attention, cfg: LMConfig, x: torch.Tensor,
                      cache: KVCache):
    """One-token decode step, x (B, 1, d). The new k and v are written IN
    PLACE into the cache at slot ``length``, which every row shares (the
    reference takes row 0's, too); the cache must have a free slot there."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    pos = cache.length.float()
    q = apply_rope(q, pos[:, None, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None, None], cfg.rope_theta)
    idx = cache.length[:1].long()
    k_cache = cache.k.index_copy_(2, idx, k.to(cache.k.dtype))
    v_cache = cache.v.index_copy_(2, idx, v.to(cache.v.dtype))
    new_len = cache.length + 1
    out = decode_attention(q, k_cache, v_cache, new_len)
    out = out.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return out @ p.wo, KVCache(k_cache, v_cache, new_len)


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d: int, ff: int, dtype: torch.dtype, device):
        super().__init__()
        self.w_gate = _param((d, ff), dtype, device)
        self.w_up = _param((d, ff), dtype, device)
        self.w_down = _param((ff, d), dtype, device)


def init_mlp(gen: torch.Generator, d: int, ff: int, dtype: torch.dtype,
             device) -> MLP:
    p = MLP(d, ff, dtype, device)
    p.w_gate.normal_(0.0, d ** -0.5, generator=gen)
    p.w_up.normal_(0.0, d ** -0.5, generator=gen)
    p.w_down.normal_(0.0, ff ** -0.5, generator=gen)
    return p


def mlp_block(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never the whole (B, S, V) logits at once)
# ---------------------------------------------------------------------------

def _xent_chunk(h: torch.Tensor, lm_head: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    logits = (h @ lm_head).float()                     # (B, chunk, V)
    logz = torch.logsumexp(logits, dim=-1)
    # the gold logit by gather: exact, as the reference's one-hot
    # contraction adds only zeros beside it (each row's index is distinct,
    # so the backward's scatter has no duplicate target)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).sum()


def chunked_softmax_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                         labels: torch.Tensor, *,
                         chunk: int = 512) -> torch.Tensor:
    """hidden (B, S, d); lm_head (d, V); labels (B, S) -> the mean loss, f32.
    Logits are f32 a chunk of ``chunk`` positions at a time, each chunk
    under ``torch.utils.checkpoint`` so its logits are recomputed in the
    backward (the reference's ``jax.checkpoint(step)``); the chunks' sums
    are added in order."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunked_softmax_xent: S={S} is not a multiple "
                         f"of the chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        tot = tot + checkpoint(_xent_chunk, hidden[:, c0:c0 + chunk],
                               lm_head, labels[:, c0:c0 + chunk],
                               use_reentrant=False, preserve_rng_state=False)
    return tot / (B * S)


def moe_block(p, cfg: LMConfig, x: torch.Tensor, *, n_groups: int):
    raise NotImplementedError("moe_block is not ported yet: MoE serving is "
                              "a later slice (ROADMAP Queue 1, item 18b)")
