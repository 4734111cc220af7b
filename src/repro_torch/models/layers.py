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

``shard_fns`` (``sharding_plan.make_shard_fns``) are applied at the
reference's points through ``shard``. A block given a DTensor (the
residual stream of a model whose parameters ``sharding_plan`` placed on a
mesh) runs its mesh version (the ``_dist`` functions at the end, after
``sharding_plan``'s module doc): Megatron's split of heads, hidden units
or experts over the model axis, the sequence where the heads do not
divide it. Given plain tensors every block computes what it computed
before, bit for bit.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..kernels.flash_attention import ops as flash_ops

Params = Dict[str, Any]


def shard(shard_fns, name: str, x):
    """The named constraint of ``shard_fns`` on ``x`` where there is one,
    else ``x``."""
    if shard_fns and name in shard_fns:
        return shard_fns[name](x)
    return x


def _dist(x) -> bool:
    from .sharding_plan import _is_dtensor
    return _is_dtensor(x)


def rms_norm(x, w, eps: float = 1e-6, psum=None, width: int = 0):
    """RMSNorm over the last dim; where that dim is split over ranks,
    ``psum`` sums the local sums of squares and ``width`` is the whole
    dim."""
    dt = x.dtype
    x = x.float()
    if psum is None:
        ms = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        ms = psum(torch.sum(x * x, dim=-1, keepdim=True)) / width
    x = x * torch.rsqrt(ms + eps)
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
    s, mask = decode_scores(q, k_cache, slot_pos, cur_pos, scale=scale,
                            window=window)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def decode_scores(q, k_cache, slot_pos, cur_pos, *, scale: float,
                  window: int):
    """``decode_attention``'s f32 scores (B, KH, H/KH, W), -1e30 where
    the mask (B, 1, 1, W) drops a slot (empty, ahead of ``cur_pos`` or
    outside the window)."""
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    qg = q.reshape(B, KH, H // KH, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    mask = (slot_pos >= 0) & (slot_pos <= cur_pos[:, None])
    if window > 0:
        mask = mask & ((cur_pos[:, None] - slot_pos) < window)
    mask = mask[:, None, None, :]
    return torch.where(mask, s, -1e30), mask


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


def rotate(q, k_raw, positions, pos3, cfg):
    """q and k (B, S, heads, hd) rotated by M-RoPE where ``cfg.m_rope``
    and ``pos3`` (3, B, S) is given, else by RoPE; -> (q, k, m_rope)."""
    if cfg.m_rope and pos3 is not None:
        sec, th = cfg.m_rope_sections, cfg.rope_theta
        return (apply_m_rope(q, pos3, sec, th),
                apply_m_rope(k_raw, pos3, sec, th), True)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k_raw, positions, cfg.rope_theta), False)


def attention_block(params: Params, x, positions, cfg, shard_fns=None,
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
    if _dist(x):
        return _attention_dist(params, x, positions, cfg, shard_fns, cache,
                               pos3)
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
    q, k, m_rope = rotate(q, k_raw, positions, pos3, cfg)
    q = shard(shard_fns, "attn_q", q)
    k = shard(shard_fns, "attn_kv", k)
    v = shard(shard_fns, "attn_kv", v)

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


def mlp_block(params: Params, x, kind: str, shard_fns=None):
    if _dist(x):
        return _mlp_dist(params, x, kind, shard_fns)
    dt = x.dtype
    gate = shard(shard_fns, "mlp_hidden", x @ params["w_gate"].to(dt))
    up = shard(shard_fns, "mlp_hidden", x @ params["w_up"].to(dt))
    act = gelu_tanh(gate) if kind == "geglu" else silu(gate)
    return (act * up) @ params["w_down"].to(dt)


def _moe_capacity(T: int, cfg) -> int:
    """Slots an expert takes per call: C = min(max(4, ceil(T·K/E·cf)), T),
    so a decode step has other capacity than its prefill."""
    C = int(max(4, math.ceil(T * cfg.experts_per_token / cfg.n_experts
                             * cfg.capacity_factor)))
    return min(C, T)


def expert_counts(idx, E: int):
    """The picks of each of E experts in ``idx`` (a static (E,) shape,
    unlike ``bincount``'s, so a fake tensor can carry it)."""
    return torch.zeros(E, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx.long(), torch.ones_like(idx, dtype=torch.long))


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
    counts = expert_counts(flat, E)
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


def moe_experts(xe, params, kind: str):
    """Each expert's gated MLP on its slots: xe (E, C, D) -> (E, C, D),
    each weight cast to xe's type just before its product."""
    dt = xe.dtype
    gate_h = torch.bmm(xe, params["w_gate"].to(dt))
    up_h = torch.bmm(xe, params["w_up"].to(dt))
    act = gelu_tanh(gate_h) if kind == "geglu" else silu(gate_h)
    return torch.bmm(act * up_h, params["w_down"].to(dt))


def moe_block(params: Params, x, cfg, shard_fns=None):
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
    if _dist(x):
        return _moe_dist(params, x, cfg, shard_fns)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, D)
    logits = xt.float() @ params["router"].float()
    C = _moe_capacity(T, cfg)
    gates_all, gate_vals, idx, place, keep = moe_route(logits, K, C)

    xe = shard(shard_fns, "moe_xe", moe_dispatch(xt, idx, place, keep, E, C))
    ye = shard(shard_fns, "moe_xe", moe_experts(xe, params, cfg.mlp))
    y = moe_combine(ye, gate_vals, idx, place, keep)

    frac = expert_counts(idx.reshape(-1), E).float() / T
    prob = gates_all.mean(0)
    aux = E * torch.sum(frac * prob)
    return y.reshape(B, S, D).to(dt), aux


# ------------------------------------------------------------ on a mesh
#
# The blocks' mesh versions (``sharding_plan``'s module doc): x is the
# residual stream, a DTensor in the ``hidden`` layout; weights are the
# plan's DTensors, gathered by ``sp.weight``; every ``to_local`` states the
# placements of its gradient.

def _columns(sf, xP, xR, w, b, split: bool):
    """x @ w (+ b) for a column-parallel weight: this rank's columns when
    ``split``; else the whole output, computed from the plan's column
    split and gathered when the plan splits ``w``'s columns, computed
    whole by every rank when it does not. ``xP``/``xR`` are x's local
    tensor with a partial or a replicated gradient."""
    from . import sharding_plan as sp
    dt = xP.dtype
    cols = split or sp.model_sharded(w)
    g = sp.partial() if cols else sp.replicate()
    y = (xP if cols else xR) @ sp.weight(sf, w, keep_model=cols,
                                         model_grad=g, dtype=dt).to(dt)
    if b is not None:
        bl = sp.weight(sf, b, keep_model=False, model_grad=g, dtype=dt)
        if cols:
            n = bl.shape[0] // sp.model_size(sf)
            r = sp.model_rank(sf)
            bl = bl[r * n:(r + 1) * n]
        y = y + bl.to(dt)
    if cols and not split:
        y = sp.wrap(sf, y, sp.act(sf, sp.shard_dim(y.ndim - 1))).redistribute(
            sf.dmesh, sp.act(sf)).to_local()
    return y


def _kv_for_heads(k, h0: int, n: int, G: int):
    """The KV heads the query heads [h0, h0 + n) read (G query heads a KV
    head), as (k', G'): a contiguous slice where each of its heads serves
    the same number of local query heads, else one KV head a query
    head."""
    lo, hi = h0 // G, (h0 + n - 1) // G + 1
    if (n % G == 0 and h0 % G == 0) or hi - lo == 1:
        return k[:, :, lo:hi], n // (hi - lo)
    idx = torch.arange(h0, h0 + n, device=k.device) // G
    return k.index_select(2, idx), 1


def _write_ring_dist(cache: Params, k, v, positions) -> None:
    """``write_ring`` into a cache of DTensors, whose local block holds
    ring slots [w0, w0 + W_l) and KV heads [h0, h0 + KH_l) of the global
    (B, W, KH, hd): k/v (B_l, S, KH, hd) hold every head; each local slot
    takes the (only) position that lands on it, if any."""
    from . import sharding_plan as sp
    ck = cache["k"]
    W = ck.shape[1]
    kl, vl = ck.to_local(), cache["v"].to_local()
    spl = cache["slot_pos"].to_local()
    w0, h0 = sp.local_offset(ck, 1), sp.local_offset(ck, 2)
    Wl, KHl = kl.shape[1], kl.shape[2]
    if k.shape[1] > W:
        k, v, positions = k[:, -W:], v[:, -W:], positions[:, -W:]
    Bl, S = positions.shape
    slots = (positions % W).long()
    inv = torch.full((Bl, W), -1, dtype=torch.long, device=k.device)
    inv.scatter_(1, slots, torch.arange(S, device=k.device).expand(Bl, S))
    inv = inv[:, w0:w0 + Wl]
    sel = inv >= 0
    src = inv.clamp(min=0)
    hd = k.shape[-1]
    gidx = src[:, :, None, None].expand(Bl, Wl, KHl, hd)
    for c, new in ((kl, k), (vl, v)):
        got = torch.gather(new[:, :, h0:h0 + KHl], 1, gidx).to(c.dtype)
        c.copy_(torch.where(sel[:, :, None, None], got, c))
    spl.copy_(torch.where(sel, torch.gather(positions.to(torch.int32), 1,
                                            src), spl))


def _decode_attention_dist(params, x, positions, cfg, sf, cache, pos3):
    """One decode step against a cache of DTensors: q/k/v of every head
    on every rank, the new k/v written into the local block of the ring,
    attention over the local slots (a softmax split over the ranks that
    share the ring's length: max, sum and output combined by
    all-reduces) or the local KV heads (gathered after), then the output
    projection."""
    from . import sharding_plan as sp
    Bl = x.to_local().shape[0]
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    xl = x.to_local()

    def proj(w, b, n):
        y = xl @ sp.weight(sf, w, keep_model=False, dtype=dt).to(dt)
        if b is not None:
            y = y + sp.weight(sf, b, keep_model=False, dtype=dt).to(dt)
        return y.reshape(Bl, 1, n, hd)

    q, k, _ = rotate(proj(params["wq"], params.get("bq"), H),
                     proj(params["wk"], params.get("bk"), KH), positions,
                     pos3, cfg)
    v = proj(params["wv"], params.get("bv"), KH)
    _write_ring_dist(cache, k, v, positions)
    ck = cache["k"]
    kl, vl = ck.to_local(), cache["v"].to_local()
    spl = cache["slot_pos"].to_local()
    h0, KHl = sp.local_offset(ck, 2), kl.shape[2]
    G = H // KH
    s, mask = decode_scores(q[:, :, h0 * G:(h0 + KHl) * G], kl, spl,
                            positions[:, 0], scale=1.0 / math.sqrt(hd),
                            window=cfg.sliding_window)
    m = s.amax(-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    l_ = e.sum(-1, keepdim=True)
    o = torch.einsum("bkgt,btkd->bkgd", e, vl.float())
    names = ck.device_mesh.mesh_dim_names
    w_axes = [a for a, p in zip(names, ck.placements)
              if p.is_shard() and p.dim == 1]
    if w_axes:
        mg = sp.all_reduce(sf, m, "max", w_axes)
        f = torch.exp(m - mg)
        l_ = sp.all_reduce(sf, l_ * f, "sum", w_axes)
        o = sp.all_reduce(sf, o * f, "sum", w_axes)
    o = (o / torch.clamp(l_, min=1e-30)).reshape(Bl, 1, KHl * G, hd)
    if KHl < KH:                        # KV heads split over the model axis
        o = sp.wrap(sf, o, sp.act(sf, sp.shard_dim(2))).redistribute(
            sf.dmesh, sp.act(sf)).to_local()
    o = o.to(dt).reshape(Bl, 1, H * hd)
    y = o @ sp.weight(sf, params["wo"], keep_model=False, dtype=dt).to(dt)
    return sp.join(sf, y, sp.act(sf)), cache


def _attention_dist(params, x, positions, cfg, sf, cache, pos3):
    """``attention_block`` on a mesh. Heads over the model axis when H
    divides it (each rank its query heads, with their KV heads: its own
    when KH divides too, else the ones its heads read, from K/V of every
    head), the output projection's partial sums all-reduced; else each
    rank takes its block of queries (``attn_q`` on the sequence) against
    K/V of every position, ``q_offset`` its block's first position, and
    the blocks are gathered. A prefill also writes the cache's local
    block (``_write_ring_dist``)."""
    from . import sharding_plan as sp
    B, S, D = x.shape
    if cache is not None and S == 1:
        return _decode_attention_dist(params, x, positions, cfg, sf, cache,
                                      pos3)
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    M, r = sp.model_size(sf), sp.model_rank(sf)
    dt = x.dtype
    Pt, Rp = sp.partial(), sp.replicate()
    heads, kv_heads = H % M == 0, KH % M == 0
    xP = sp.local(x, sp.act(sf, Pt))          # used for this rank's heads
    xR = sp.local(x, sp.act(sf, Rp))          # used whole, as every rank
    Bl = xR.shape[0]

    def proj(w, b, split: bool):
        """x @ w (+ b) as (B_l, S, heads, hd): this rank's columns when
        ``split``, else every column (``_columns``)."""
        return _columns(sf, xP, xR, w, b, split).reshape(Bl, S, -1, hd)

    q = proj(params["wq"], params.get("bq"), heads)
    k_raw = proj(params["wk"], params.get("bk"), heads and kv_heads)
    v = proj(params["wv"], params.get("bv"), heads and kv_heads)
    q, k, m_rope = rotate(q, k_raw, positions, pos3, cfg)
    kv_pl = sp.act(sf, sp.shard_dim(2) if heads and kv_heads else Rp)
    if cache is not None:               # a prefill: every head, every slot
        ring_k = apply_rope(k_raw, positions, cfg.rope_theta) if m_rope \
            else k
        full = [sp.wrap(sf, t, kv_pl).redistribute(sf.dmesh, sp.act(sf))
                .to_local() for t in (ring_k, v)]
        _write_ring_dist(cache, full[0], full[1], positions)

    qd = shard(sf, "attn_q", sp.wrap(
        sf, q, sp.act(sf, sp.shard_dim(2) if heads else Rp)))
    q_off = sp.local_offset(qd, 1)
    ql = qd.to_local()
    kv_grad = None if heads and kv_heads else sp.act(sf, Pt)
    kl = sp.local(shard(sf, "attn_kv", sp.wrap(sf, k, kv_pl)), kv_grad)
    vl = sp.local(shard(sf, "attn_kv", sp.wrap(sf, v, kv_pl)), kv_grad)
    if heads and not kv_heads:
        n = H // M
        kl, _ = _kv_for_heads(kl, r * n, n, H // KH)
        vl, _ = _kv_for_heads(vl, r * n, n, H // KH)
    scale = 1.0 / math.sqrt(hd)
    out = xla_flash(ql, kl, vl, scale=scale, causal=cfg.causal,
                    window=cfg.sliding_window, q_offset=q_off)
    out = out.reshape(Bl, out.shape[1], -1)
    wo = sp.weight(sf, params["wo"], keep_model=heads, model_grad=Pt,
                   dtype=dt)
    y = out @ wo.to(dt)
    return sp.join(sf, y, sp.act(sf, Pt if heads else sp.shard_dim(1)),
                   shape=(B, S, y.shape[-1])), cache


def _mlp_dist(params, x, kind: str, sf):
    """``mlp_block`` on a mesh: run on this rank's hidden units where they
    divide the model axis (``mlp_hidden``), the down projection's partial
    sums then all-reduced; else every rank computes the whole block."""
    from . import sharding_plan as sp
    dt = x.dtype
    split = params["w_gate"].shape[-1] % sp.model_size(sf) == 0
    g = sp.partial() if split else sp.replicate()
    w = sp.Lazy(**{k: (lambda k=k: sp.weight(
        sf, params[k], keep_model=split, model_grad=g, dtype=dt))
        for k in ("w_gate", "w_up", "w_down")})
    hidden = sp.act(sf, sp.shard_dim(2) if split else sp.replicate())
    y = mlp_block(w, sp.local(x, sp.act(sf, g)), kind,
                  sp.local_fns(sf, mlp_hidden=hidden))
    return sp.join(sf, y, sp.act(sf, g))


def _moe_dist(params, x, cfg, sf):
    """``moe_block`` on a mesh, the reference's semantics over the global
    batch: routing (every rank, from the whole router), each pick's place
    in its expert's queue counted over the global token order (the data
    ranks before this one add their counts), the capacity of the global
    token count; experts over the model axis where they divide it
    (``moe_xe``), each rank filling its experts' slots of the (E, C, D)
    buffer with its tokens, summed over the data axes (one writer a
    slot), running its experts on the whole buffer and combining its own
    tokens from its experts' outputs, the partial sums all-reduced over
    the model axis. aux is this data rank's share of the Switch loss (the
    shares sum to the reference's)."""
    from . import sharding_plan as sp
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    M, r = sp.model_size(sf), sp.model_rank(sf)
    dt = x.dtype
    Pt, Rp = sp.partial(), sp.replicate()
    e_split = E % M == 0
    g = Pt if e_split else Rp
    xR = sp.local(x, sp.act(sf, Rp))
    Bl = xR.shape[0]
    T = Bl * S
    Tg = T * sp.dp_count(sf)
    router = sp.weight(sf, params["router"], keep_model=False, model_grad=Rp)
    lg = sp.wrap(sf, (xR.reshape(T, D).float() @ router.float())
                 .reshape(Bl, S, E), sp.act(sf, Rp))
    lg_gate = lg.to_local(grad_placements=sp.act(sf, g)).reshape(T, E)
    lg_aux = lg.to_local().reshape(T, E)
    C = _moe_capacity(Tg, cfg)
    _, gate_vals, idx, place, _ = moe_route(lg_gate, K, C)
    counts = expert_counts(idx.reshape(-1), E)
    place = place + sp.dp_prefix(sf, counts)[idx]
    keep = place < C

    El = E // M if e_split else E
    e0 = r * El if e_split else 0
    mine = keep & (idx >= e0) & (idx < e0 + El)
    xd = sp.local(x, sp.act(sf, g)).reshape(T, D)
    xe = moe_dispatch(xd, idx - e0, place, mine, El, C)
    dp = sp._dp_axes(sf.mesh)
    ep = sp.shard_dim(0) if e_split else Rp
    names = sf.mesh.axis_names
    # the buffer: experts over the model axis; each data rank's slots
    # (summed) or every data rank's (whole)
    whole = [ep if a == "model" else Rp for a in names]
    summed = [ep if a == "model" else
              (Pt if a in dp and sf.batch_split else Rp) for a in names]
    xe = shard(sf, "moe_xe", sp.wrap(sf, xe, summed).redistribute(
        sf.dmesh, whole)).to_local()

    ye = moe_experts(xe, sp.Lazy(**{
        k: (lambda k=k: sp.weight(sf, params[k], keep_model=e_split,
                                  model_grad=g, dp_grad=Rp, dtype=dt))
        for k in ("w_gate", "w_up", "w_down")}), cfg.mlp)
    ye = shard(sf, "moe_xe", sp.wrap(sf, ye, whole)).to_local(
        grad_placements=summed)
    y = moe_combine(ye, gate_vals, idx - e0, place, mine)
    y = sp.join(sf, y.reshape(Bl, S, D), sp.act(sf, g), dtype=dt)

    frac = sp.all_reduce(sf, counts, "sum",
                         dp if sf.batch_split else ()).float() / Tg
    prob = torch.softmax(lg_aux, dim=-1).sum(0) / Tg
    aux = E * torch.sum(frac * prob)
    return y, aux
