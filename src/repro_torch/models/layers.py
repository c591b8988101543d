"""Transformer building blocks of the LM family: RMSNorm, RoPE, attention
(prefill and training through the ``flash_attention`` kernel, one-token
decode against a KV cache), the SwiGLU MLP, the capacity-bucketed MoE and
the chunked cross-entropy. Counterpart of ``repro/models/layers.py``.

Weights keep the reference's layout (``x @ w`` with ``w`` of shape
``(d_in, d_out)``), so they carry across by name
(``transformer.params_from_numpy``). The MoE's expert products are
``torch.bmm`` over the buckets: the reference computes them as
``jnp.einsum`` outside any kernel. The reference's ``opt_barrier`` steers
XLA and has no counterpart.

Under a real train mesh (``sharding.rules.activation_mesh`` of a
``DeviceMesh``) each process holds its model part of every weight, as
``sharding.rules.lm_specs`` places it, and the blocks compute on their own
heads, columns, experts and vocabulary rows: Megatron's tensor
parallelism, with the collectives of ``sharding.spmd`` where the
reference's ``constrain`` calls (kept at their places, the identity on a
plain tensor) pin a layout. An axis that ``_guard`` leaves whole (a head
count the model axis does not divide) is computed whole on every process.

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

from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.core import router
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.sharding import rules, spmd
from repro_torch.sharding.rules import constrain

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
    """Inverse frequencies, shape (head_dim // 2,), f32: the reference's
    three f32 steps (``i / head_dim``, ``theta ** e``, ``1 / p``), each
    taken in f64 and rounded to f32, so each is the correctly rounded f32
    value on either device. Torch's f32 ``pow`` is 1 ulp off for some
    exponents (qwen2's index 37, phi3's 20) and ``pos * inv`` multiplies
    that by the position; the card divides by a scalar as a product with
    its reciprocal, inexact at head_dim 96. XLA's f32 ``pow`` is not
    correctly rounded everywhere either (head_dim 112, theta 1e6, index
    16), but it is at every configured (head_dim, theta)."""
    e = (torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
         / head_dim).float()
    p = (theta ** e.double()).float()
    return (1.0 / p.double()).float()


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


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, valid: torch.Tensor):
    """``decode_attention`` over one process's segment of a cache whose
    sequence a mesh splits, unnormalised, for ``spmd.merge_softmax``:
    valid (B, S_l) marks the segment's slots below the cache's length.
    Returns f32 (m, l, acc): (B, Hkv, g, 1) the scores' max (-inf where
    the segment holds no valid slot), (B, Hkv, g, 1) the sum of
    exp(s - m) (0 there) and (B, Hkv, g, hd) the p-weighted sum of v. p
    stays f32 (the one-card form rounds p / l to the cache's dtype
    before its product with v, which a merge can do only after the
    normalisation: a bf16 cache's results differ from one card's by that
    rounding)."""
    B, Hq, _, hd = q.shape
    Hkv = k_cache.shape[1]
    qg = (q / math.sqrt(hd)).reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float())
    s = torch.where(valid[:, None, None, :], s, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return m, l, acc


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, Hkv, S, hd)
    v: torch.Tensor          # (B, Hkv, S, hd)
    length: torch.Tensor     # (B,) int32 — valid prefix length


class SeqSplit(NamedTuple):
    """How a mesh splits a KV cache's sequence: the ``spmd.Axis``es that
    split it (major first; none: every process holds every slot) and this
    process's segment among their product, slots ``index * S_l`` to
    ``(index + 1) * S_l - 1`` of its block of S_l."""
    axes: tuple
    index: int


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


def draw_attn(p: Attention, gen: torch.Generator) -> Attention:
    """N(0, 1/d) projections drawn from ``gen`` into ``p`` in the order
    wq, wk, wv, wo; the biases stay zero."""
    std = p.wq.shape[0] ** -0.5
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


def _split(n: int, tp) -> bool:
    """Whether the model axis splits a dimension of ``n``: the rules'
    ``_guard``, which leaves an axis that does not divide it whole."""
    return tp.size > 1 and n % tp.size == 0


def _project_qkv_tp(p, cfg: LMConfig, x: torch.Tensor, tp):
    """``_project_qkv`` with the model axis: (q, k, v, whether q and whether
    k and v hold only this process's heads). A column-parallel projection
    gives this process's columns; columns that are parts of heads (a head
    count the axis does not divide) are joined whole."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    xs = spmd.tp_copy(x, tp)

    def proj(w, b, heads):
        split = _split(heads * hd, tp)
        t = (xs if split else x) @ w
        if b is not None:
            t = t + b
        if split and heads % tp.size:
            # joined along the last axis: copied so the head dim stays
            # contiguous, as the card's attention kernels take it
            t, split = spmd.tp_gather(t, -1, tp).contiguous(), False
        t = t.view(B, S, -1, hd).transpose(1, 2)
        return constrain(t, "dp", "tp", None, None), split

    bias = cfg.qkv_bias
    q, q_loc = proj(p.wq, p.bq if bias else None, cfg.n_heads)
    k, kv_loc = proj(p.wk, p.bk if bias else None, cfg.n_kv_heads)
    v, _ = proj(p.wv, p.bv if bias else None, cfg.n_kv_heads)
    return q, k, v, q_loc, kv_loc


def _heads_tp(q, k, v, cfg: LMConfig, q_loc: bool, kv_loc: bool, tp):
    """q, k and v for this process's attention: its own q heads with the
    k/v heads they read (a slice of whole k/v heads when the axis splits q
    heads but not k/v heads: Qwen2's 2 k/v heads under 4), or every head
    whole. Returns (q, k, v, whether q holds only this process's heads)."""
    if q_loc and not kv_loc:
        g = cfg.n_heads // cfg.n_kv_heads
        hl = q.shape[1]
        if hl % g == 0 or g % hl == 0:
            lo = tp.index * hl
            k0, k1 = lo // g, (lo + hl - 1) // g + 1
            k = spmd.tp_copy(k, tp)[:, k0:k1]
            v = spmd.tp_copy(v, tp)[:, k0:k1]
            return q, k, v, True
        q = spmd.tp_gather(q, 1, tp)
    elif kv_loc and not q_loc:
        k, v = spmd.tp_gather(k, 1, tp), spmd.tp_gather(v, 1, tp)
    return q, k, v, q_loc and kv_loc


def _attn_tp(p, cfg: LMConfig, x: torch.Tensor, positions, tp):
    """Full-sequence attention on this process's heads; the row-parallel
    output projection's partial sums added over the model axis. Returns
    (out, k, v): k and v as projected, this process's heads when the axis
    splits them, else every head."""
    B, S, _ = x.shape
    q, k, v, q_loc, kv_loc = _project_qkv_tp(p, cfg, x, tp)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    k_out, v_out = k, v
    q, k, v, local = _heads_tp(q, k, v, cfg, q_loc, kv_loc, tp)
    out = chunked_attention(q, k, v, causal=True)
    out = out.transpose(1, 2).reshape(B, S, -1)
    if _split(cfg.n_heads * cfg.head_dim, tp):       # wo: this process's rows
        if not local:
            out = spmd.tp_split(out, -1, tp)
        return spmd.tp_reduce(out @ p.wo, tp), k_out, v_out
    out = constrain(out, "dp", None, "tp")   # every head: wo is whole
    return out @ p.wo, k_out, v_out


def attn_block(p: Attention, cfg: LMConfig, x: torch.Tensor, *,
               positions: torch.Tensor, cache: Optional[KVCache] = None):
    """Full-sequence attention (prefill). Returns (out, new_cache); the
    cache, when given, receives this sequence's k and v. Under a real
    mesh each process attends with its own heads, and the new cache's k
    and v are this process's heads when the model axis splits them (every
    head otherwise), for ``transformer.prefill_step`` to lay out."""
    tp = spmd.tp_axis()
    if tp is not None:
        out, k, v = _attn_tp(p, cfg, x, positions, tp)
        if cache is None:
            return out, None
        B, S, _ = x.shape
        return out, KVCache(k.to(cache.k.dtype), v.to(cache.v.dtype),
                            torch.full((B,), S, dtype=torch.int32,
                                       device=x.device))
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=True)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    out = constrain(out, "dp", None, "tp")
    new_cache = None
    if cache is not None:
        new_cache = KVCache(k=k.to(cache.k.dtype), v=v.to(cache.v.dtype),
                            length=torch.full((B,), S, dtype=torch.int32,
                                              device=x.device))
    return out @ p.wo, new_cache


def _attn_decode_mesh(p, cfg: LMConfig, x: torch.Tensor, cache: KVCache,
                      seq: SeqSplit, tp):
    """``attn_decode_block`` on a real mesh whose axes ``seq`` split the
    cache's sequence: q, k and v column-parallel, joined to every head
    (each process holds every head of its own slots); the one process
    whose segment holds slot ``length`` (row 0's) writes the new k and v
    there, every other one writes its own slot back; each process attends
    over its segment and the parts are merged over ``seq.axes``; then
    ``wo`` row-parallel."""
    B = x.shape[0]
    hd = cfg.head_dim
    q, k, v, q_loc, kv_loc = _project_qkv_tp(p, cfg, x, tp)
    pos = cache.length.float()
    q = apply_rope(q, pos[:, None, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None, None], cfg.rope_theta)
    if q_loc:
        q = spmd.tp_gather(q, 1, tp)
    if kv_loc:
        k, v = spmd.tp_gather(k, 1, tp), spmd.tp_gather(v, 1, tp)
    S_l = cache.k.shape[2]
    first = seq.index * S_l
    rel = cache.length[:1].long() - first
    mine = ((rel >= 0) & (rel < S_l)).reshape(1, 1, 1, 1)
    idx = rel.clamp(0, S_l - 1)
    for c, new in ((cache.k, k), (cache.v, v)):
        c.index_copy_(2, idx, torch.where(mine, new.to(c.dtype),
                                          c.index_select(2, idx)))
    new_len = cache.length + 1
    slots = first + torch.arange(S_l, device=x.device)
    valid = slots[None, :] < new_len.reshape(-1, 1)
    m, l, acc = decode_attention_partial(q, cache.k, cache.v, valid)
    out = spmd.merge_softmax(m, l, acc, seq.axes)
    out = out.reshape(B, cfg.n_heads, 1, hd).to(cache.v.dtype)
    out = out.transpose(1, 2).reshape(B, 1, cfg.n_heads * hd)
    if _split(cfg.n_heads * hd, tp):                 # wo: this process's rows
        out = spmd.tp_reduce(spmd.local_part(out, -1, tp) @ p.wo, tp)
    else:
        out = out @ p.wo
    return out, KVCache(cache.k, cache.v, new_len)


def attn_decode_block(p: Attention, cfg: LMConfig, x: torch.Tensor,
                      cache: KVCache, seq: Optional[SeqSplit] = None):
    """One-token decode step, x (B, 1, d). The new k and v are written IN
    PLACE into the cache at slot ``length``, which every row shares (the
    reference takes row 0's, too); the cache must have a free slot there.
    Under a real mesh ``cache`` is this process's block and ``seq`` says
    how the mesh splits its sequence (``_attn_decode_mesh``; none when
    omitted)."""
    tp = spmd.tp_axis()
    if tp is not None:
        return _attn_decode_mesh(p, cfg, x, cache, seq or SeqSplit((), 0),
                                 tp)
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


def draw_mlp(p: MLP, gen: torch.Generator) -> MLP:
    """N(0, 1/d) ``w_gate``, ``w_up`` and N(0, 1/ff) ``w_down`` drawn from
    ``gen`` into ``p``, in that order."""
    d, ff = p.w_gate.shape
    p.w_gate.normal_(0.0, d ** -0.5, generator=gen)
    p.w_up.normal_(0.0, d ** -0.5, generator=gen)
    p.w_down.normal_(0.0, ff ** -0.5, generator=gen)
    return p


def silu(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference writes it, x * sigmoid(x), in two
    ops: in bf16 the product rounds where the reference's does. (XLA also
    rounds inside its sigmoid, so an MoE layer's bf16 output differs from
    the reference's by up to 1 ulp; ``F.silu``, one rounding, by 2.)
    Every MLP and expert of the port takes it."""
    return h * torch.sigmoid(h)


def mlp_block(p: MLP, x: torch.Tensor, *, width: Optional[int] = None
              ) -> torch.Tensor:
    """The SwiGLU MLP. Under a real mesh ``width`` (the hidden width,
    which each process may hold a part of) says whether the model axis
    splits it: then the gate and up products are this process's columns
    and the down product's partial sums are added over the axis."""
    tp = spmd.tp_axis()
    split = tp is not None and _split(width, tp)
    if split:
        x = spmd.tp_copy(x, tp)
    h = silu(x @ p.w_gate) * (x @ p.w_up)
    h = constrain(h, "dp", None, "tp")
    y = h @ p.w_down
    return spmd.tp_reduce(y, tp) if split else y


# ---------------------------------------------------------------------------
# MoE: capacity-bucketed dispatch
# ---------------------------------------------------------------------------
#
# The routing of WebParF's URL dispatcher (core/router.py): score -> top-k
# -> position in the expert's bucket by cumsum -> drop past capacity ->
# scatter to (E, C) buckets -> expert GEMMs -> gather back -> weighted
# combine. Under an active mesh shape (``sharding.rules.activation_mesh``)
# the tokens route in the groups the reference's mesh path (``_moe_spmd``)
# routes them in, each with its own capacity (``_moe_grouped``).


class MoE(nn.Module):
    """The routed experts in the reference's layout: ``router`` (d, E)
    f32, ``w_gate``/``w_up`` (E, d, f_e), ``w_down`` (E, f_e, d); ``shared``
    (DeepSeekMoE) an MLP of width n_shared * f_e, ``dense`` (Arctic's
    dense residual) an MLP of width ``d_ff_dense or d_ff``."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype, device):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        self.router = _param((d, m.n_experts), torch.float32, device)
        self.w_gate = _param((m.n_experts, d, m.d_ff_expert), dtype, device)
        self.w_up = _param((m.n_experts, d, m.d_ff_expert), dtype, device)
        self.w_down = _param((m.n_experts, m.d_ff_expert, d), dtype, device)
        self.shared = (MLP(d, m.n_shared * m.d_ff_expert, dtype, device)
                       if m.n_shared else None)
        self.dense = (MLP(d, m.d_ff_dense or cfg.d_ff, dtype, device)
                      if m.dense_residual else None)


def draw_moe(p: MoE, gen: torch.Generator) -> MoE:
    """The reference's scales (N(0, 1/d), ``w_down`` N(0, 1/f_e)) drawn
    from ``gen`` into ``p`` in the order router, w_gate, w_up, w_down,
    shared, dense."""
    d, f_e = p.w_gate.shape[1:]
    for w in (p.router, p.w_gate, p.w_up):
        w.normal_(0.0, d ** -0.5, generator=gen)
    p.w_down.normal_(0.0, f_e ** -0.5, generator=gen)
    for mlp in (p.shared, p.dense):
        if mlp is not None:
            draw_mlp(mlp, gen)
    return p


def init_moe(gen: torch.Generator, cfg: LMConfig, dtype: torch.dtype,
             device) -> MoE:
    """An ``MoE`` of ``cfg`` drawn from ``gen`` (``draw_moe``)."""
    return draw_moe(MoE(cfg, dtype, device), gen)


def moe_capacity(m: MoEConfig, tokens_per_group: int) -> int:
    return router.moe_capacity(tokens_per_group, m.top_k, m.n_experts,
                               m.capacity_factor)


def moe_dispatch(router_logits: torch.Tensor, m: MoEConfig, capacity: int):
    """Group-local top-k routing with capacity bucketing.

    router_logits (G, T, E). Returns (combine_w (G, T, K) f32, expert_idx
    (G, T, K), slot_idx (G, T, K), keep (G, T, K), aux_loss f32 scalar).
    The top-k is a stable descending sort, so ties go to the lower expert
    index as ``lax.top_k`` sends them (``torch.topk`` does not)."""
    G, T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :m.top_k], top_e[..., :m.top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    slot, keep = router.position_in_bucket(
        top_e.reshape(G, T * m.top_k), E, capacity)
    slot = slot.reshape(G, T, m.top_k)
    keep = keep.reshape(G, T, m.top_k)

    # load-balancing aux loss (Switch/GShard style)
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(top_e, E).float().sum(2).mean(
        dim=(0, 1))
    aux = (me * ce).sum() * E * m.aux_loss_weight
    return top_w, top_e, slot, keep, aux


def _moe_scatter(xt, e_idx, slot, keep, offset, E: int, n: int):
    """(G*T, d) tokens of G groups -> (E, n, d) buckets, n = G*C, one
    k-slice at a time, as the reference's loop. A token's group owns C
    slots an expert from ``offset`` (G*T, 1) = its g * C on, so an
    expert's slots run group after group. Kept assignments own distinct
    cells and are copied there; a dropped one goes to a spare slot past
    each expert's n, which the returned view leaves out. The reference
    ADDS a dropped assignment as zeros at slot C - 1, so its buckets are
    the same (a -0.0 token is +0.0 there: compare with ==). Copies, not
    adds: no atomics, and no write order decides a cell."""
    d = xt.shape[1]
    buckets = torch.zeros((E * (n + 1), d), dtype=xt.dtype,
                          device=xt.device)
    for k in range(e_idx.shape[-1]):
        s_spare = torch.where(keep[:, k], slot[:, k] + offset[:, 0], n)
        buckets.index_copy_(0, e_idx[:, k] * (n + 1) + s_spare, xt)
    return buckets.view(E, n + 1, d)[:, :n]


def _moe_combine(y, w, e_idx, slot, keep, offset, capacity: int):
    """Per-k-slice gather + weighted sum in f32, k = 0..K-1 in order:
    (E, G*C, d) -> (G*T, d), each token at its group's ``offset`` as in
    ``_moe_scatter``. Dropped assignments are gathered too, from their
    group's slot C - 1, and weighted 0, as in the reference; in the
    backward only those zeros meet at a shared cell, so the gradient is
    exact in any order."""
    T = e_idx.shape[0]
    n = y.shape[1]
    yf = y.reshape(-1, y.shape[-1])
    out = torch.zeros((T, y.shape[-1]), dtype=torch.float32,
                      device=y.device)
    for k in range(e_idx.shape[-1]):
        s_safe = torch.where(keep[:, k], slot[:, k], capacity - 1)
        got = yf.index_select(0, e_idx[:, k] * n + s_safe + offset[:, 0])
        out = out + torch.where(keep[:, k], w[:, k], 0.0)[:, None] \
            * got.float()
    return out


def _experts(p, buckets):
    """The routed experts' SwiGLU over (E, N, d) buckets: ``bmm``s."""
    h = torch.bmm(buckets, p.w_gate)
    u = torch.bmm(buckets, p.w_up)
    return torch.bmm(silu(h) * u, p.w_down)


def _group_aux(logits: torch.Tensor, top_e: torch.Tensor, m: MoEConfig):
    """The load-balancing loss of each group, (G,) f32: ``moe_dispatch``'s
    formula over one group's (T, E) logits at a time."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=1)
    ce = torch.nn.functional.one_hot(top_e, E).float().sum(2).mean(dim=1)
    return (me * ce).sum(-1) * E * m.aux_loss_weight


def _moe_grouped(p, m: MoEConfig, x: torch.Tensor, dp: int, tp: int):
    """MoE over x (B, S, d) routed in dp * tp groups: route (an f32 GEMM)
    -> bucket -> expert GEMMs -> combine. This is the reference's mesh
    path (``_moe_spmd``) on one card, and at (1, 1) its local path. Its
    device (i, j) of a (dp, tp) mesh routes the block ``x[i*B_l:(i+1)*B_l,
    j*S_l:(j+1)*S_l]``, flattened b-major, with its own capacity
    ``moe_capacity(m, B_l * S_l)``; its two ``all_to_all``s move buckets
    between devices and change no value. So here the G = dp * tp blocks
    route as groups (``moe_dispatch`` over (G, T, E)), one ``bmm`` an
    expert runs over every group's slots, and aux is the mean of the
    groups' losses (the reference's ``pmean``), not ``moe_dispatch``'s
    mean over groups and tokens together, which is the same number only
    at G = 1. Returns (out (B, S, d) in x's dtype, aux)."""
    B, S, d = x.shape
    Bl, Sl = B // dp, S // tp
    G, T, E, K = dp * tp, Bl * Sl, m.n_experts, m.top_k
    xg = x.reshape(dp, Bl, tp, Sl, d).transpose(1, 2).reshape(G * T, d)
    logits = (xg.float() @ p.router).view(G, T, E)
    capacity = moe_capacity(m, T)
    w, e_idx, slot, keep, aux = moe_dispatch(logits, m, capacity)
    if G > 1:
        aux = _group_aux(logits, e_idx, m).mean()
    w, e_idx, slot, keep = (t.reshape(G * T, K)
                            for t in (w, e_idx, slot, keep))
    offset = (torch.arange(G * T, device=x.device) // T * capacity)[:, None]
    buckets = _moe_scatter(xg, e_idx, slot, keep, offset, E, G * capacity)
    y = _experts(p, buckets)
    out = _moe_combine(y, w, e_idx, slot, keep, offset, capacity)
    out = out.to(x.dtype).reshape(dp, tp, Bl, Sl, d).transpose(1, 2)
    return out.reshape(B, S, d), aux


def _moe_spmd(p, m: MoEConfig, x: torch.Tensor, tp):
    """The reference's expert-parallel MoE on a real mesh. x (B_l, S, d)
    is this data process's batch, replicated over the model axis; model
    process j routes its own block of tokens, ``x[:, j*S_l:(j+1)*S_l]``
    flattened b-major (``_moe_grouped``'s group (i, j)), with its own
    capacity, then the (E, C, d) buckets go to the process of their
    experts (E / tp a process) by one ``all_to_all`` over the model axis
    and come back by another after the expert products. aux is the mean of
    every process's group loss (the reference's ``pmean``). Returns (out
    (B_l, S, d) in x's dtype, replicated over the axis, aux)."""
    Bl, S, d = x.shape
    E = m.n_experts
    xt = spmd.tp_split(x, 1, tp).reshape(-1, d)
    T = xt.shape[0]
    router_w = spmd.tp_copy(p.router, tp)
    logits = (xt.float() @ router_w)[None]
    capacity = moe_capacity(m, T)
    w, e_idx, slot, keep, aux = moe_dispatch(logits, m, capacity)
    w, e_idx, slot, keep = w[0], e_idx[0], slot[0], keep[0]
    offset = torch.zeros((T, 1), dtype=torch.long, device=x.device)
    buckets = _moe_scatter(xt, e_idx, slot, keep, offset, E, capacity)
    # EP exchange: each process keeps E / tp experts, gains tp x tokens
    b = spmd.tp_all_to_all(buckets, tp)               # (tp * E/tp, C, d)
    b = b.view(tp.size, E // tp.size, capacity, d).transpose(0, 1) \
        .reshape(E // tp.size, tp.size * capacity, d)
    y = _experts(p, b)
    y = y.view(E // tp.size, tp.size, capacity, d).transpose(0, 1) \
        .reshape(E, capacity, d)
    y = spmd.tp_all_to_all(y, tp)
    out = _moe_combine(y, w, e_idx, slot, keep, offset, capacity)
    out = out.to(x.dtype).view(Bl, -1, d)
    out = constrain(out, "dp", "tp", None)
    return spmd.tp_gather(out, 1, tp), spmd.mesh_mean(aux, tp)


def _moe_one_group(p, m: MoEConfig, x: torch.Tensor, rows, tp):
    """The reference's ``_moe_local`` on a real mesh: every token of the
    step routed as one group. x (B_l, S, d) is this data process's rows
    (``rows`` the data axes that split them, major first; none when every
    process holds every row); the tokens are joined over ``rows``, routed
    once (every process alike, as one card routes them: ``_moe_grouped``
    at (1, 1)), each model process runs its own experts (all of them when
    the axis does not divide E), the experts' outputs are joined over the
    model axis and combined in the one-card order, and this process keeps
    its rows. For a decode step, whose tokens are few. Inference only: a
    gradient would not pass the joins."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("moe_block: the one-group route on a mesh serves "
                         "only; a train step's model axis must divide S "
                         "and the experts")
    B, S, d = x.shape
    E = m.n_experts
    xt = spmd.gather_axes(x.reshape(B * S, d), 0, rows)
    T = xt.shape[0]
    logits = (xt.float() @ p.router)[None]
    capacity = moe_capacity(m, T)
    w, e_idx, slot, keep, aux = moe_dispatch(logits, m, capacity)
    w, e_idx, slot, keep = w[0], e_idx[0], slot[0], keep[0]
    offset = torch.zeros((T, 1), dtype=torch.long, device=x.device)
    buckets = _moe_scatter(xt, e_idx, slot, keep, offset, E, capacity)
    split = _split(E, tp)
    y = _experts(p, spmd.local_part(buckets, 0, tp) if split else buckets)
    if split:
        y = spmd.tp_gather(y, 0, tp)
    out = _moe_combine(y, w, e_idx, slot, keep, offset, capacity)
    mine = 0
    for a in rows:
        mine = mine * a.size + a.index
    out = out.view(-1, B * S, d)[mine]
    return out.to(x.dtype).view(B, S, d), aux


def moe_block(p, cfg: LMConfig, x: torch.Tensor, *, n_groups: int = 1,
              rows=None):
    """x (B, S, d) -> (out, aux_loss): the routed experts, then the shared
    experts and the dense residual added in the reference's order. The
    reference's choice between its paths: under an active mesh shape
    whose data axes divide B and whose model axis divides S and E, its
    groups (``_moe_grouped`` at (dp, tp)); otherwise all B * S tokens as
    one group (at (1, 1); decode's S = 1 under a model axis > 1 among
    them). Under a real mesh x is this process's rows, split over the
    data axes ``rows`` (all of them by default; none when every process
    holds every row, as a serving mesh holds fewer rows than data
    processes): the groups are the processes' (``_moe_spmd``) under the
    same condition on the whole batch, and otherwise one group
    (``_moe_one_group``). ``n_groups`` is unused, as in the reference. No
    host sync: every size is known from the shapes."""
    m = cfg.moe
    B, S, _ = x.shape
    tp = spmd.tp_axis()
    if tp is not None:
        dps = spmd.dp_axes()
        rows = dps if rows is None else tuple(rows)
        n_dp = n_rows = 1
        for a in dps:
            n_dp *= a.size
        for a in rows:
            n_rows *= a.size
        if (B * n_rows) % n_dp or len(rows) != len(dps) or S % tp.size \
                or m.n_experts % tp.size:
            out, aux = _moe_one_group(p, m, x, rows, tp)
        else:
            out, aux = _moe_spmd(p, m, x, tp)
    else:
        groups = rules.active_groups()
        if groups is None or B % groups[0] or S % groups[1] \
                or m.n_experts % groups[1]:
            groups = (1, 1)
        out, aux = _moe_grouped(p, m, x, *groups)
    if m.n_shared:
        out = out + mlp_block(p.shared, x,
                              width=m.n_shared * m.d_ff_expert)
    if m.dense_residual:
        out = out + mlp_block(p.dense, x, width=m.d_ff_dense or cfg.d_ff)
    return out, aux


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


def _xent_chunk_tp(h: torch.Tensor, lm_head: torch.Tensor,
                   labels: torch.Tensor, tp) -> torch.Tensor:
    """``_xent_chunk`` with the vocabulary split over the model axis
    (Megatron's vocab-parallel cross-entropy): this process's logits are
    its columns of the head; the max, the sum of exponentials and the gold
    logit (from the one process that holds it, zeros elsewhere) are
    combined over the axis."""
    logits = (h @ lm_head).float()
    logits = constrain(logits, "dp", None, "tp")
    v = logits.shape[-1]
    m = spmd.tp_max(logits.amax(dim=-1), tp)
    se = spmd.tp_reduce(torch.exp(logits - m[..., None]).sum(-1), tp)
    logz = m + torch.log(se)
    rel = labels.long() - tp.index * v
    mine = (rel >= 0) & (rel < v)
    gold = logits.gather(-1, rel.clamp(0, v - 1)[..., None])[..., 0]
    gold = spmd.tp_reduce(torch.where(mine, gold, 0.0), tp)
    return (logz - gold).sum()


def chunked_softmax_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 512,
                         vocab: Optional[int] = None) -> torch.Tensor:
    """hidden (B, S, d); lm_head (d, V); labels (B, S) -> the mean loss, f32.
    Logits are f32 a chunk of ``chunk`` positions at a time, each chunk
    under ``torch.utils.checkpoint`` so its logits are recomputed in the
    backward (the reference's ``jax.checkpoint(step)``); the chunks' sums
    are added in order. Under a real mesh whose model axis splits
    ``vocab`` (V, of which ``lm_head`` holds this process's columns) the
    loss is vocab-parallel."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunked_softmax_xent: S={S} is not a multiple "
                         f"of the chunk {chunk}")
    tp = spmd.tp_axis()
    fn, extra = _xent_chunk, ()
    if tp is not None and _split(vocab, tp):
        fn, extra = _xent_chunk_tp, (tp,)
        hidden = spmd.tp_copy(hidden, tp)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        tot = tot + checkpoint(fn, hidden[:, c0:c0 + chunk],
                               lm_head, labels[:, c0:c0 + chunk], *extra,
                               use_reentrant=False, preserve_rng_state=False)
    return tot / (B * S)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """The embedding of ``tokens`` (``F.embedding``, whose backward is
    deterministic on the card). Under a real mesh whose model axis splits
    the ``vocab`` rows, ``table`` holds this process's rows, looked up
    row-parallel (``spmd.row_parallel_lookup``): the lookup's bits."""
    tp = spmd.tp_axis()
    if tp is None or not _split(vocab, tp):
        return torch.nn.functional.embedding(tokens, table)
    return spmd.row_parallel_lookup(
        table, tokens, tp, lambda t, i: torch.nn.functional.embedding(i, t))
