"""The plain PyTorch version of the ``flash_attention`` kernel.

Replays the TPU kernel's contract (repro/kernels/flash_attention/
flash_attention.py:26-60, ``_kernel``): per query row, q is cast to f32
and scaled by 1/sqrt(hd) after the cast; the KV tiles of ``block_k`` are
walked in order from tile 0 with an online softmax whose running max ``m``,
denominator ``l`` and accumulator are f32; ``p`` stays f32 for p·v; masked
scores (``q_pos < k_pos`` when causal, positions counted from 0) are
-1e30, not -inf; the output is ``acc / max(l, 1e-30)`` in q's dtype. GQA is
by index: query head h reads KV head ``h // group``, and no K or V is
repeated. A ragged last tile is a shorter tile. Under ``causal`` the tiles
wholly above the last query row are skipped: every score in them is masked,
so they would add exactly 0 to ``l`` and the accumulator.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, group: int = 1,
              block_k: int = 128) -> torch.Tensor:
    """q (BHq, Sq, hd); k, v (BHkv, Skv, hd) with BHq = BHkv * group.
    Returns (BHq, Sq, hd) in q.dtype."""
    BHq, Sq, hd = q.shape
    BHkv, Skv = k.shape[0], k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    # the group's query rows of one KV head side by side: (BHkv, G*Sq, hd)
    qf = (q.float() * scale).reshape(BHkv, group * Sq, hd)
    q_pos = torch.arange(Sq, device=q.device).repeat(group)
    m = torch.full((BHkv, group * Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((BHkv, group * Sq, hd), dtype=torch.float32,
                      device=q.device)
    n_kv = min(Skv, Sq) if causal else Skv
    for k0 in range(0, n_kv, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        s = torch.matmul(qf, kb.transpose(1, 2))          # (BHkv, G*Sq, bk)
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(BHq, Sq, hd).to(q.dtype)


# the reference's name for its plain attention, of the same contract
attention_ref = flash_ref
