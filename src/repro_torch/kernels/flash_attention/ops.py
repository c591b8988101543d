"""The ``flash_attention`` wrapper: GQA-aware causal attention.

Counterpart of ``repro/kernels/flash_attention/ops.py`` (``attention``).
Dispatch is by device, and on the card by dtype and head dim, as
:func:`route` states it:

- a CPU tensor takes the plain version (``ref.flash_ref``);
- a meta tensor gets the output's shape and dtype, and the kernel the card
  would launch records its operations (the causal count) and bytes for the
  dry run (``registry.record_meta``);
- a CUDA bf16 tensor whose head dim is in ``TC_HEAD_DIMS`` (64, 96, 128)
  launches ``flash_attention_tc`` (``csrc/flash_attention_tc.cu``): both
  products on the tensor cores, ``p`` rounded to bf16 for p·v as the
  reference's bf16 LM path rounds it;
- every other CUDA tensor (f32, and bf16 at head dims 8, 16 and 32)
  launches ``flash_attention`` (``csrc/flash_attention.cu``): both
  products on the tensor cores in split TF32 (three TF32 products per f32
  product, each k-step's sum added in f32 rounded to nearest) with ``p``
  kept in f32, the TPU kernel's contract. PyTorch's TF32 flags play no
  part: the split is the kernel's own.

This is a route, not a fallback: each kernel counts its own launches, and a
launch either kernel refuses raises. The bf16 route meets the reference's
bf16 tolerance (2e-2); the f32 contract (2e-5) stays on the split-TF32
kernel.

GQA is folded as ``_gqa_fold`` folds it: the query heads of batch row b are
grouped by KV head, so query head h reads KV head ``h // group``. The plain
version gets the folded tensors; the kernels get the unfolded ones with
their strides and do the same fold by index, so q, k and v may be strided
views such as those ``layers._project_qkv`` makes (``(B, S, H, hd)``
transposed to ``(B, H, S, hd)``). On the prefill path only v arrives so and
is read without a copy; RoPE has already made q and k new contiguous
tensors. The kernels' output is laid out ``(B, Sq, Hq, hd)`` in memory and
returned as its ``(B, Hq, Sq, hd)`` view, so the attention block's
transpose back is free.

``attention`` is differentiable: a ``torch.autograd.Function`` runs the
route above forward and a plain PyTorch backward (``flash_backward``), the
gradient the reference gets from autodiff of ``layers.chunked_attention``.
The TPU kernel has no backward kernel, so neither does the port: the
backward is the same code on the card and on the CPU, in f32 whatever the
input dtype, one KV tile at a time.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.build import Kernel
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_ref

# flash_attention_launch(q, k, v, o, B, Hq, Hkv, Sq, Skv, hd, is_bf16,
#   causal, q strides (b, h, s), k strides, v strides, o strides, stream)
KERNEL = Kernel("flash_attention", n_ptr=4, n_int=20)
HEAD_DIMS = (8, 16, 32, 64, 96, 128)       # the kernel's instantiations
# flash_attention_tc_launch(q, k, v, o, B, Hq, Hkv, Sq, Skv, hd, causal,
#   q strides (b, h, s), k strides, v strides, o strides, stream)
TC_KERNEL = Kernel("flash_attention_tc", n_ptr=4, n_int=19)
TC_HEAD_DIMS = (64, 96, 128)               # bf16 only
DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1


def _gqa_fold(q, k, v) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                int]:
    """(B, Hq, S, hd) q rows grouped as (B*Hkv, group) so the plain
    version's ``h // group`` KV index lines up."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B * Hkv * group, Sq, hd)
    kf = k.reshape(B * Hkv, Skv, hd)
    vf = v.reshape(B * Hkv, Skv, hd)
    return qg, kf, vf, group


def _check(q, k, v, block_q, block_k):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"flash_attention: want q (B, Hq, Sq, hd) and k, v "
                         f"(B, Hkv, Skv, hd) with Hkv dividing Hq, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: want float32 or bfloat16 for all "
                        f"three, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: tensors on different devices")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"flash_attention: blocks {block_q}, {block_k} < 1")


def route(device_type: str, dtype: torch.dtype, hd: int
          ) -> Optional[Kernel]:
    """The kernel that ``attention`` launches for a device type, a dtype
    and a head dim: ``None`` on the CPU (the plain version), ``TC_KERNEL``
    for bf16 at ``TC_HEAD_DIMS`` on the card, ``KERNEL`` for the rest of the
    card's cases; on meta, the kernel the card would launch (its meta
    route). Raises for a device or head dim no kernel takes."""
    if registry.resolve_impl(KERNEL.name, device_type) == "ref":
        return None
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return TC_KERNEL
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    return KERNEL


def launch(kernel: Kernel, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, causal: bool) -> torch.Tensor:
    """One launch of ``kernel`` (``KERNEL`` or ``TC_KERNEL``) on CUDA
    tensors checked by ``_check``; returns (B, Hq, Sq, hd) in q.dtype."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B == 0 or Sq == 0:
        return out
    strides = []
    for t in (q, k, v, out):
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError("flash_attention: the head dim must be "
                             "contiguous")
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    if max(strides) > _INT_MAX or max(B, Hq, Sq, Skv) > _INT_MAX:
        raise ValueError("flash_attention: a stride or size beyond int32")
    if kernel is TC_KERNEL:
        if any(t.data_ptr() % 16 for t in (q, k, v)) \
                or any(st % 8 for st in strides):
            raise ValueError("flash_attention_tc: q, k and v rows must "
                             "start 16-byte aligned (strides multiples of "
                             "8 elements)")
        args = (int(causal),)
    else:
        args = (int(q.dtype == torch.bfloat16), int(causal))
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Hq, Hkv, Sq, Skv, hd, *args, *strides)
    return out


def attention_flops(B: int, Hq: int, Sq: int, Skv: int, hd: int,
                    causal: bool) -> int:
    """The two products' operations: under ``causal`` (query i at position
    Skv - Sq + i) only the keys at or before each query's position."""
    if not causal:
        return 4 * B * Hq * hd * Sq * Skv
    first = Skv - Sq + 1
    return 4 * B * Hq * hd * (Sq * first + Sq * (Sq - 1) // 2)


def _forward(q, k, v, causal: bool, block_k: int) -> torch.Tensor:
    B, Hq, Sq, hd = q.shape
    kernel = route(q.device.type, q.dtype, hd)
    impl = registry.resolve_impl(KERNEL.name, q.device.type)
    with registry.launch_scope(KERNEL.name if kernel is None
                               else kernel.name, impl):
        if kernel is None:
            qg, kf, vf, group = _gqa_fold(q, k, v)
            out = flash_ref(qg, kf, vf, causal=causal, group=group,
                            block_k=max(1, min(block_k, k.shape[2])))
            return out.reshape(B, Hq, Sq, hd)
        if impl == "meta":
            out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype,
                              device=q.device).transpose(1, 2)
            registry.record_meta(
                kernel.name,
                attention_flops(B, Hq, Sq, k.shape[2], hd, causal),
                registry.nbytes(q, k, v, out))
            return out
        return launch(kernel, q, k, v, causal)


def flash_backward(q, k, v, o, do, *, causal: bool, block_k: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``attention`` at (q, k, v) given its output ``o``
    and the output's cotangent ``do``: (dq, dk, dv) in the inputs' dtypes.

    Plain PyTorch in f32, in two passes over the KV tiles of ``block_k``,
    never an (Sq, Skv) tensor. The first recomputes each tile's scores
    from q and k and keeps the online softmax's row max ``m`` and
    denominator ``l``, as the reference's ``jax.checkpoint(kv_step)``
    recomputes ``p``. The second recomputes ``p = exp(s - m) / l`` a tile
    at a time and takes ``dv += p^T do``, ``dp = do v^T``,
    ``ds = p * (dp - rowsum(do * o))``, ``dq += ds k``, ``dk += ds^T q``
    (q scaled by 1/sqrt(hd); dq scaled by it once more), dk and dv summed
    over each GQA group. Under ``causal`` a tile reads only the query rows
    at or past its first key: the blocks wholly above the diagonal are
    skipped, as the forward skips them.

    On ``meta`` (the dry run) only the first KV tile is walked in each
    pass: it holds the most query rows, so its temporaries are the largest
    of any tile's, and every other tile allocates the same tensors or
    smaller ones; the products of the tiles not walked are counted with
    ``registry.record_meta`` under ``flash_backward``."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    f32 = dict(dtype=torch.float32, device=q.device)
    # (B*Hkv, G, Sq, hd): the query rows of one KV head's group together
    qs = (q.float() * scale).reshape(B * Hkv, G, Sq, hd)
    dof = do.float().reshape(B * Hkv, G, Sq, hd)
    delta = (dof * o.float().reshape(B * Hkv, G, Sq, hd)).sum(dim=-1)
    kf = k.float().reshape(B * Hkv, Skv, hd)
    vf = v.float().reshape(B * Hkv, Skv, hd)
    q_pos = torch.arange(Sq, device=q.device)
    n_kv = min(Skv, Sq) if causal else Skv
    tiles = range(0, n_kv, block_k)
    if q.device.type == "meta":
        rest = tiles[1:]
        rows = sum(Sq - (min(k0, Sq) if causal else 0) for k0 in rest)
        # a tile's products: s in each pass, then dv, dp, dq, dk
        prods = 7 * 2 * B * Hq * rows * block_k * hd
        registry.record_meta("flash_backward", prods, 0)
        tiles = tiles[:1]

    def scores(k0):
        """(first query row, this tile's f32 scores (BHkv, G, rows, bk))
        with masked scores at -1e30."""
        r0 = min(k0, Sq) if causal else 0
        kb = kf[:, k0:k0 + block_k]
        s = torch.matmul(qs[:, :, r0:], kb.transpose(1, 2)[:, None])
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            s = s.masked_fill(q_pos[r0:, None] < k_pos[None, :], NEG_INF)
        return r0, s

    m = torch.full((B * Hkv, G, Sq), NEG_INF, **f32)
    l = torch.zeros((B * Hkv, G, Sq), **f32)
    for k0 in tiles:
        r0, s = scores(k0)
        m_new = torch.maximum(m[..., r0:], s.amax(dim=-1))
        l[..., r0:] = l[..., r0:] * torch.exp(m[..., r0:] - m_new) + \
            torch.exp(s - m_new[..., None]).sum(dim=-1)
        m[..., r0:] = m_new
    inv_l = 1.0 / torch.clamp(l, min=1e-30)

    dq = torch.zeros((B * Hkv, G, Sq, hd), **f32)
    dk = torch.zeros((B * Hkv, Skv, hd), **f32)
    dv = torch.zeros((B * Hkv, Skv, hd), **f32)
    for k0 in tiles:
        r0, s = scores(k0)
        k1 = min(k0 + block_k, Skv)
        p = torch.exp(s - m[..., r0:, None]) * inv_l[..., r0:, None]
        do_r = dof[:, :, r0:]
        dv[:, k0:k1] = torch.matmul(p.transpose(-1, -2), do_r).sum(dim=1)
        dp = torch.matmul(do_r, vf[:, None, k0:k1].transpose(-1, -2))
        ds = p * (dp - delta[..., r0:, None])
        dq[:, :, r0:] += torch.matmul(ds, kf[:, None, k0:k1])
        dk[:, k0:k1] = torch.matmul(ds.transpose(-1, -2),
                                    qs[:, :, r0:]).sum(dim=1)
    return ((dq * scale).reshape(B, Hq, Sq, hd).to(q.dtype),
            dk.reshape(B, Hkv, Skv, hd).to(k.dtype),
            dv.reshape(B, Hkv, Skv, hd).to(v.dtype))


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_k):
        o = _forward(q, k, v, causal, block_k)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.block_k = causal, block_k
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, do, causal=ctx.causal,
                                    block_k=ctx.block_k)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, block_q: int = 128,
              block_k: int = 128) -> torch.Tensor:
    """q (B, Hq, Sq, hd); k, v (B, Hkv, Skv, hd). Returns (B, Hq, Sq, hd) in
    q.dtype, from the kernel :func:`route` names; differentiable through
    :func:`flash_backward`. ``block_k`` is the plain version's KV tile and
    the backward's; the kernels' tiles are fixed, and the results agree
    up to f32 rounding (and, on the bf16 tensor-core route, p's rounding to
    bf16). ``block_q`` changes no result (query rows are independent) and
    stays for the reference's signature."""
    _check(q, k, v, block_q, block_k)
    return _Attention.apply(q, k, v, causal, block_k)
