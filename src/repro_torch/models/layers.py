"""Shared NN layers on PyTorch: RMSNorm, RoPE, GQA attention, sliding
window, gated MLPs — the port of ``repro/models/layers.py`` for the dense
attention family.

Plain functions over explicit parameter dicts, as in the reference. Prefill
attention (``xla_flash``) goes through the flash-attention kernel
(``csrc/flash_attention.cu``) on a CUDA tensor and through its plain
version, the reference's blocked online-softmax schedule, on a CPU tensor;
it is the function the reference computes in XLA and that the TPU kernel
implements, so the port adds no switch. Decode attention over the ring
cache is plain PyTorch, as in the reference. ``moe_block`` and
``apply_m_rope`` are not ported (ROADMAP.md §1 item 14).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as flash_ops

Params = Dict[str, Any]


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


# ------------------------------------------------------------------- RoPE

def _rope_angles(positions, head_dim: int, theta: float):
    """positions: (..., S) -> cos/sin (..., S, head_dim/2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D) rotated pairwise-half style; positions: (B, S)."""
    half = x.shape[-1] // 2
    cos, sin = _rope_angles(positions, x.shape[-1], theta)   # (B, S, half)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# -------------------------------------------------------------- attention

def xla_flash(q, k, v, *, scale: float, causal: bool, window: int,
              q_offset: int = 0):
    """Online-softmax attention, scores blocked over KV.

    q: (B, S, H, D); k/v: (B, T, KH, D). Returns (B, S, H, D).
    q_offset: absolute position of q[0] (prefill continuation support).
    """
    return flash_ops.attention(q, k, v, scale=scale, causal=causal,
                               window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *, scale: float,
                     window: int):
    """Single-token attention over a (ring-buffer) cache.

    q: (B, 1, H, D); caches: (B, W, KH, D); slot_pos: (B, W) absolute
    positions (-1 = empty); cur_pos: (B,).
    """
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    g = H // KH
    qg = q.reshape(B, KH, g, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    mask = (slot_pos >= 0) & (slot_pos <= cur_pos[:, None])
    if window > 0:
        mask = mask & ((cur_pos[:, None] - slot_pos) < window)
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def write_ring(cache: Params, k, v, positions) -> None:
    """Write k/v (B, S, KH, D) at ring slots ``pos % W``, in place; one
    token in decode, a prompt in prefill, of which a ring of W slots keeps
    the last W."""
    W = cache["k"].shape[1]
    if k.shape[1] > W:
        k, v, positions = k[:, -W:], v[:, -W:], positions[:, -W:]
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    slots = (positions % W).long()
    cache["k"][bidx, slots] = k.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v.to(cache["v"].dtype)
    cache["slot_pos"][bidx, slots] = positions.to(torch.int32)


def attention_block(params: Params, x, positions, cfg,
                    cache: Optional[Params] = None):
    """Full attention sub-layer (pre-norm residual outside).

    Returns (out, new_cache). With a cache, x of one token (B, 1, D)
    decodes against it and a longer x is a prefill that fills it from its
    own rotated k/v; either way the ring cache is updated in place (the
    reference returns an updated copy; the port saves the copy) and
    returned.
    """
    B, S, D = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype

    def proj(w, b, n):
        y = x @ w.to(dt)
        if b is not None:
            y = y + b.to(dt)
        return y.reshape(B, S, n, hd)

    q = proj(params["wq"], params.get("bq"), H)
    k = proj(params["wk"], params.get("bk"), KH)
    v = proj(params["wv"], params.get("bv"), KH)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    scale = 1.0 / math.sqrt(hd)
    if cache is not None:
        write_ring(cache, k, v, positions)
    if cache is not None and S == 1:
        out = decode_attention(q, cache["k"], cache["v"], cache["slot_pos"],
                               positions[:, 0], scale=scale,
                               window=cfg.sliding_window)
    else:
        out = xla_flash(q, k, v, scale=scale, causal=cfg.causal,
                        window=cfg.sliding_window)
    out = out.reshape(B, S, H * hd)
    return out @ params["wo"].to(dt), cache


# ------------------------------------------------------------------- MLPs

def mlp_block(params: Params, x, kind: str):
    dt = x.dtype
    gate = x @ params["w_gate"].to(dt)
    up = x @ params["w_up"].to(dt)
    # jax.nn.gelu is the tanh approximation by default
    act = F.gelu(gate, approximate="tanh") if kind == "geglu" else F.silu(gate)
    return (act * up) @ params["w_down"].to(dt)
