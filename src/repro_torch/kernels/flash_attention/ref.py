"""Plain PyTorch versions of the flash-attention kernel
(``csrc/flash_attention.cu``).

``attention_ref`` is the reference's materialized-scores oracle
(``repro/kernels/flash_attention/ref.py``) in (B, H, S, D).
``blocked_attention`` is the kernel's own function in the LM's layout, the
schedule of ``repro/models/layers.py::xla_flash``: key chunks of 1,024, an
online softmax with the ``-1e30`` sentinel, p zeroed after the exp, and
``acc / max(l, 1e-30)`` in q's type.
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e30


def attention_ref(q, k, v, *, scale: float, causal: bool, window: int = 0):
    """q (B, H, S, D), k/v (B, KH, S, D) -> (B, H, S, D) in q's type."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    p = torch.where(mask, p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def blocked_attention(q, k, v, *, scale: float, causal: bool, window: int,
                      q_offset: int = 0, kv_chunk: int = 1024):
    """q (B, S, H, D), k/v (B, T, KH, D) -> (B, S, H, D) in q's type.

    ``q_offset`` is the absolute position of q[:, 0]; key j sits at j.
    """
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    g = H // KH
    qg = q.reshape(B, S, KH, g, D).float()
    kv_chunk = min(kv_chunk, T)
    q_pos = q_offset + torch.arange(S, device=q.device)
    m = torch.full((B, S, KH, g), NEG_INF, device=q.device)
    l = torch.zeros((B, S, KH, g), device=q.device)
    acc = torch.zeros((B, S, KH, g, D), device=q.device)
    for c0 in range(0, T, kv_chunk):
        kb = k[:, c0:c0 + kv_chunk].float()
        vb = v[:, c0:c0 + kv_chunk].float()
        k_pos = c0 + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bskgd,btkd->bskgt", qg, kb) * scale
        mask = torch.ones((S, k_pos.numel()), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window > 0:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bskgt,btkd->bskgd", p,
                                                    vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, S, H, D).to(q.dtype)
