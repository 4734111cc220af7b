"""Shared NN layers on PyTorch: RMSNorm, RoPE / M-RoPE, GQA attention,
sliding window, gated MLPs, capacity-based top-k MoE — the port of
``repro/models/layers.py``.

Plain functions over explicit parameter dicts, as in the reference. Prefill
attention (``xla_flash``) goes through the flash-attention kernel
(``csrc/flash_attention.cu``) on a CUDA tensor and through its plain
version, the reference's blocked online-softmax schedule, on a CPU tensor;
it is the function the reference computes in XLA and that the TPU kernel
implements, so the port adds no switch. Its gradient is a recompute in
plain PyTorch, chunked over query blocks (``ops.attention_backward``),
where the reference differentiates its XLA scan. Decode attention over
the ring cache is plain PyTorch, as in the reference. So is
``moe_block``, which the reference computes in XLA too; it builds its
dispatch from indices instead of the reference's (T, E, C) one-hot
tensors (ROADMAP.md §3).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

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


def apply_m_rope(x, positions3, sections, theta: float):
    """Multimodal RoPE (qwen2-vl): head_dim/2 split into (t, h, w) sections,
    each rotated by its own position stream. positions3: (3, B, S). Each
    section has its own frequencies, ``1 / theta^(arange(sec) / sec)``."""
    half = x.shape[-1] // 2
    cs, ss = [], []
    for pos, sec in zip(positions3, sections):
        c, s = _rope_angles(pos, 2 * sec, theta)     # (B, S, sec)
        cs.append(c)
        ss.append(s)
    cos = torch.cat(cs, dim=-1)[:, :, None, :]
    sin = torch.cat(ss, dim=-1)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# -------------------------------------------------------------- attention

def xla_flash(q, k, v, *, scale: float, causal: bool, window: int,
              q_offset: int = 0):
    """Online-softmax attention, scores blocked over KV.

    q: (B, S, H, D); k/v: (B, T, KH, D). Returns (B, S, H, D).
    q_offset: absolute position of q[0] (prefill continuation support).
    Differentiable: the backward recomputes in query blocks
    (``ops.attention_backward``).
    """
    return flash_ops.flash_attention_lm(q, k, v, scale=scale, causal=causal,
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
                    cache: Optional[Params] = None, pos3=None):
    """Full attention sub-layer (pre-norm residual outside).

    Returns (out, new_cache). With a cache, x of one token (B, 1, D)
    decodes against it and a longer x is a prefill that fills it; either
    way the ring cache is updated in place (the reference returns an
    updated copy; the port saves the copy) and returned. q and k rotate
    by M-RoPE when ``cfg.m_rope`` and ``pos3`` (3, B, S) is given, else by
    RoPE; a prefill writes plain-RoPE keys all the same, as the
    reference's ``transformer._prefill_attn_cache`` does (ROADMAP.md §3).
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
    k_raw = proj(params["wk"], params.get("bk"), KH)
    v = proj(params["wv"], params.get("bv"), KH)
    m_rope = cfg.m_rope and pos3 is not None
    if m_rope:
        q = apply_m_rope(q, pos3, cfg.m_rope_sections, cfg.rope_theta)
        k = apply_m_rope(k_raw, pos3, cfg.m_rope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k_raw, positions, cfg.rope_theta)

    scale = 1.0 / math.sqrt(hd)
    decode = cache is not None and S == 1
    if cache is not None:
        ring_k = k
        if m_rope and not decode:
            ring_k = apply_rope(k_raw, positions, cfg.rope_theta)
        write_ring(cache, ring_k, v, positions)
    if decode:
        out = decode_attention(q, cache["k"], cache["v"], cache["slot_pos"],
                               positions[:, 0], scale=scale,
                               window=cfg.sliding_window)
    else:
        out = xla_flash(q, k, v, scale=scale, causal=cfg.causal,
                        window=cfg.sliding_window)
    out = out.reshape(B, S, H * hd)
    return out @ params["wo"].to(dt), cache


# ------------------------------------------------------------------- MLPs

def silu(x):
    """x · 1 / (1 + e^-x), one operation at a time in x's type: the
    reference's ``jax.nn.silu`` as XLA computes it, so bf16 results agree
    bit for bit (``F.silu`` rounds once and differs in the last bit)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x):
    """The reference's default ``jax.nn.gelu`` (the tanh approximation),
    one operation at a time in x's type, its two constants rounded to that
    type first as jnp rounds them, so bf16 results agree bit for bit."""
    def const(c):                        # a 0-d CPU tensor acts as a scalar
        return torch.tensor(c, dtype=torch.float64).to(x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(const(math.sqrt(2 / math.pi))
                                  * (x + const(0.044715) * (x * x * x))))
    return x * cdf


def mlp_block(params: Params, x, kind: str):
    dt = x.dtype
    gate = x @ params["w_gate"].to(dt)
    up = x @ params["w_up"].to(dt)
    act = gelu_tanh(gate) if kind == "geglu" else silu(gate)
    return (act * up) @ params["w_down"].to(dt)


def _moe_capacity(T: int, cfg) -> int:
    """Slots an expert takes per call: C = min(max(4, ceil(T·K/E·cf)), T),
    so a decode step has other capacity than its prefill."""
    C = int(max(4, math.ceil(T * cfg.experts_per_token / cfg.n_experts
                             * cfg.capacity_factor)))
    return min(C, T)


def moe_route(logits, K: int, C: int):
    """Routing from f32 router logits (T, E): the softmax gates of every
    expert (T, E), the K picks' renormalized gates and experts (T, K), each
    pick's place in its expert's queue, counted in token-major, pick-minor
    order as the reference's ``cumsum`` over its flattened (T·K, E) one-hot
    counts it, and the mask of picks whose place is below the capacity C.
    """
    T, E = logits.shape
    gates_all = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(gates_all, K, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat = idx.reshape(T * K)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    place = torch.empty_like(flat)
    sorted_e = flat[order]
    place[order] = torch.arange(T * K, device=flat.device) - starts[sorted_e]
    place = place.reshape(T, K)
    return gates_all, gate_vals, idx, place, place < C


def moe_dispatch(xt, idx, place, keep, E: int, C: int):
    """The experts' inputs (E, C, D): token t's row at (e, place) for each
    kept pick (t, e), zeros elsewhere. Built in a buffer of E·C + 1 rows
    whose last row takes the dropped picks, so no mask is read back to the
    host; the reference's one-hot einsum adds only zeros to each kept row,
    so these are its bits."""
    T, D = xt.shape
    row = torch.where(keep, idx * C + place, E * C)
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
    for k in range(idx.shape[1]):
        buf[row[:, k]] = xt
    return buf[:E * C].view(E, C, D)


def moe_combine(ye, gate_vals, idx, place, keep):
    """Each token's K expert outputs (E, C, D), weighted by their gates and
    summed in f32 -> (T, D); a dropped pick adds nothing."""
    E, C, D = ye.shape
    T, K = idx.shape
    w = gate_vals * keep
    ye = ye.reshape(E * C, D)
    row = torch.where(keep, idx * C + place, 0)
    y = torch.zeros((T, D), dtype=torch.float32, device=ye.device)
    for k in range(K):
        y += w[:, k, None] * ye[row[:, k]].float()
    return y


def moe_block(params: Params, x, cfg):
    """Capacity-based top-k MoE (Switch dispatch). x: (B, S, D) -> (y,
    aux_loss).

    The reference's function, with the dispatch built from indices: the
    kept token rows are copied into an (E, C, D) buffer (the reference's
    one-hot einsum adds only zeros to them, so the buffer is the
    reference's bit for bit), the experts run as batched products over E,
    and each token gathers its K outputs back, weighted by their gates
    (the reference adds the same K terms in another order). Nothing of
    size (T, E, C) is made. aux is the Switch loss E·Σ frac·prob, with
    ``frac`` counting picks before drops.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, D)
    logits = xt.float() @ params["router"].float()
    C = _moe_capacity(T, cfg)
    gates_all, gate_vals, idx, place, keep = moe_route(logits, K, C)

    xe = moe_dispatch(xt, idx, place, keep, E, C)
    gate_h = torch.bmm(xe, params["w_gate"].to(dt))
    up_h = torch.bmm(xe, params["w_up"].to(dt))
    act = gelu_tanh(gate_h) if cfg.mlp == "geglu" else silu(gate_h)
    ye = torch.bmm(act * up_h, params["w_down"].to(dt))
    y = moe_combine(ye, gate_vals, idx, place, keep)

    frac = torch.bincount(idx.reshape(-1), minlength=E).float() / T
    prob = gates_all.mean(0)
    aux = E * torch.sum(frac * prob)
    return y.reshape(B, S, D).to(dt), aux
