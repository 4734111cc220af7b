"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) blocks on PyTorch:
the port of ``repro/models/mamba2.py``.

The sequence is chunked; within a chunk the recurrence is the quadratic,
attention-like form (one (Q, Q) masked product per chunk and head); across
chunks only the (heads, head_dim, state) states are carried, by a Python
loop over the chunks (the reference's ``lax.scan``). ngroups = 1 (B/C
shared across heads). The reference computes all of it in XLA, outside
any Pallas kernel, so the port computes it in plain PyTorch. Its two
four-operand einsums are written as staged products: the largest tensor
made is the (B, nc, nh, Q, Q) decay, never a (B, nc, Q, Q, nh, hp) one.

Decode is the O(1) recurrent update: h' = h * exp(dt*A) + dt * (B ⊗ x).

Given a DTensor (a model placed on a mesh, ``sharding_plan``), the mixer
runs ``mamba2_dist``: the input projection and the conv on every rank,
then the SSD of this rank's heads (``ssm_x`` over the model axis where
the heads divide it), the gated norm's sum of squares all-reduced, and
the output projection's partial sums all-reduced.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _conv1d_causal(x, w, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, S, C), w: (K, C). With ``state``
    ((B, K-1, C), decode) returns (y, new_state); the state and x are
    promoted to one type first, as ``jnp.concatenate`` does."""
    K = w.shape[0]
    if state is not None:
        dt = torch.promote_types(state.dtype, x.dtype)
        xs = torch.cat([state.to(dt), x.to(dt)], dim=1)      # (B, K-1+S, C)
        new_state = xs[:, -(K - 1):, :]
    else:
        xs = F.pad(x, (0, 0, K - 1, 0))
        new_state = None
    L = xs.shape[1]
    y = sum(xs[:, i: L - (K - 1 - i), :] * w[i] for i in range(K))
    return y, new_state


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int = 128,
                h0: Optional[torch.Tensor] = None):
    """SSD forward.

    x: (B, S, nh, hp); dt: (B, S, nh) (post-softplus); A: (nh,) negative;
    Bm/Cm: (B, S, st). Returns (y, h_last) with h: (B, nh, hp, st).
    """
    Bsz, S, nh, hp = x.shape
    st = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S_p = S + pad
    nc = S_p // chunk
    Q = chunk
    xc = x.reshape(Bsz, nc, Q, nh, hp).float()
    dtc = dt.reshape(Bsz, nc, Q, nh)
    Bc = Bm.reshape(Bsz, nc, Q, st)
    Cc = Cm.reshape(Bsz, nc, Q, st)

    dA = dtc * A[None, None, None, :]                        # (B,nc,Q,nh) <= 0
    cs = torch.cumsum(dA, dim=2)                             # within-chunk
    total = cs[:, :, -1:, :]                                 # (B,nc,1,nh)

    # intra-chunk (quadratic form): y_i += sum_{j<=i} (C_i.B_j) e^{cs_i-cs_j}
    # dt_j x_j, heads leading so each (Q, Q) block is one batched product
    CB = Cc @ Bc.transpose(-1, -2)                           # (B,nc,i,j)
    csh = cs.permute(0, 1, 3, 2)                             # (B,nc,nh,Q)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: for i<j the exponent is positive and exp overflows to
    # inf; where(mask, inf, 0) is fine forward but its backward emits
    # 0 * inf = NaN. Inside the mask (i>=j) cs is non-increasing so diff<=0.
    L = torch.where(mask, torch.exp(torch.where(
        mask, csh[..., :, None] - csh[..., None, :], 0.0)), 0.0)
    L = L * CB[:, :, None]                                   # (B,nc,nh,i,j)
    xdt = (dtc[..., None] * xc).permute(0, 1, 3, 2, 4)       # (B,nc,nh,j,hp)
    y_intra = L @ xdt                                        # (B,nc,nh,i,hp)
    del L

    # chunk states: S_n = sum_j B_j ⊗ (dt_j x_j) e^{cs_end - cs_j}
    w = torch.exp(total - cs) * dtc                          # (B,nc,Q,nh)
    wx = (w[..., None] * xc).reshape(Bsz, nc, Q, nh * hp)
    states = (wx.transpose(-1, -2) @ Bc).reshape(Bsz, nc, nh, hp, st)

    # inter-chunk recurrence, emitting the state before each chunk
    gamma = torch.exp(total[:, :, 0, :])                     # (B,nc,nh)
    h = h0 if h0 is not None else torch.zeros(
        (Bsz, nh, hp, st), dtype=torch.float32, device=x.device)
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h)
        h = h * gamma[:, n, :, None, None] + states[:, n]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B,nc,nh,hp,st)

    # inter-chunk contribution: y_i += (C_i . h_prev) * e^{cs_i}
    y_inter = (Cc[:, :, None] @ h_prevs.transpose(-1, -2)) \
        * torch.exp(csh)[..., None]                          # (B,nc,nh,i,hp)
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4)           # (B,nc,i,nh,hp)
    y = y.reshape(Bsz, S_p, nh, hp)[:, :S]
    return y.to(x.dtype), h


def _in_proj(params: Params, x, cfg):
    """The mixer's input projection, split: z, the conv input (x, B, C)
    and the raw dt."""
    return _split_in_proj(x @ params["in_proj"].to(x.dtype), cfg)


def _split_in_proj(zxbcdt, cfg):
    """The input projection's output as z, the conv input and raw dt."""
    di, st = cfg.d_inner, cfg.ssm_state
    z, xin, Bm, Cm, dt_raw = torch.split(
        zxbcdt, [di, di, st, st, zxbcdt.shape[-1] - 2 * di - 2 * st], dim=-1)
    return z, torch.cat([xin, Bm, Cm], dim=-1), dt_raw


def _ssm_inputs(params: Params, conv_out, dt_raw, cfg, dt_):
    """After the conv: SiLU, the split into x (B, S, nh, hp), B and C, the
    softplus step dt (f32) and A (f32, negative). The parameters are cast
    to the compute type ``dt_``; a conv output of a wider type (a conv
    state wider than the compute type) keeps its type, as jnp promotes."""
    from .layers import silu
    di, st = cfg.d_inner, cfg.ssm_state
    B, S = conv_out.shape[:2]
    conv_out = silu(conv_out + params["conv_b"].to(dt_))
    xin, Bm, Cm = torch.split(conv_out, [di, st, st], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xin.reshape(B, S, cfg.ssm_heads, cfg.ssm_head_dim)
    return xh, Bm, Cm, dt, A


def _out_proj(params: Params, y, xh, z, cfg, dt_, psum=None):
    """D skip, gated RMSNorm and the output projection, in the type of
    ``xh`` (the compute type ``dt_`` or a wider one, as above); on a mesh
    of some of the heads, ``psum`` sums the norm's squares over them."""
    from .layers import rms_norm, silu
    B, S = xh.shape[:2]
    y = y.to(dt_) + xh * params["D"].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, -1)
    y = rms_norm(y, params["norm"], cfg.rms_eps, psum=psum,
                 width=cfg.d_inner) * silu(z)
    return y @ params["out_proj"].to(dt_).to(y.dtype)


def _ssm_step(h, xh, dt, A, Bm, Cm):
    """The O(1) decode update of one token: h (B, nh, hp, st) ->
    (y (B, 1, nh, hp), h')."""
    dt1 = dt[:, 0]                                        # (B,nh)
    g = torch.exp(dt1 * A[None, :])
    upd = (dt1[:, :, None] * xh[:, 0].float())[..., None] \
        * Bm[:, 0].float()[:, None, None, :]              # (B,nh,hp,st)
    h_new = h * g[:, :, None, None] + upd
    y = (h_new @ Cm[:, 0].float()[:, None, :, None])[..., 0]
    return y.reshape(xh.shape[0], 1, *xh.shape[2:]), h_new


def mamba2_block(params: Params, x, cfg, shard_fns=None,
                 cache: Optional[Params] = None):
    """Full Mamba2 mixer. x: (B, S, D); cache: {'conv': (B,K-1,C), 'ssm': h}.

    Returns (out, new_cache): with a cache, the O(1) decode step of one
    token and a new cache dict; without, the chunked SSD and None."""
    from .layers import _dist, shard
    if _dist(x):
        return mamba2_dist(params, x, cfg, shard_fns, cache)
    B, S, D = x.shape
    dt_ = x.dtype
    z, conv_in, dt_raw = _in_proj(params, x, cfg)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _conv1d_causal(conv_in, params["conv_w"].to(dt_),
                                        conv_state)
    xh, Bm, Cm, dt, A = _ssm_inputs(params, conv_out, dt_raw, cfg, dt_)
    xh = shard(shard_fns, "ssm_x", xh)

    if cache is not None:
        y, h_new = _ssm_step(cache["ssm"], xh, dt, A, Bm, Cm)
        new_cache = {"conv": new_conv, "ssm": h_new}
    else:
        y, _ = ssd_chunked(xh, dt, A, Bm.float(), Cm.float())
        new_cache = None
    return _out_proj(params, y, xh, z, cfg, dt_), new_cache


def mamba2_dist(params: Params, x, cfg, sf, cache: Optional[Params] = None,
                prefill: bool = False):
    """The mixer on a mesh (module doc). ``cache`` (DTensors) makes it a
    decode step; ``prefill`` returns the new cache of a prompt (the last
    K-1 conv inputs and the final state); both in ``cache_pspecs``'s
    placements."""
    from . import sharding_plan as sp
    from .layers import _columns, shard
    B, S, D = x.shape
    dt_ = x.dtype
    M, r = sp.model_size(sf), sp.model_rank(sf)
    nh, hp = cfg.ssm_heads, cfg.ssm_head_dim
    split = nh % M == 0
    Pt, Rp = sp.partial(), sp.replicate()
    g = Pt if split else Rp
    xR = sp.local(x, sp.act(sf, Rp))

    def whole(name, grad=Rp):
        return sp.weight(sf, params[name], keep_model=False, model_grad=grad)

    full = {"conv_b": whole("conv_b"), "dt_bias": whole("dt_bias"),
            "A_log": whole("A_log", g)}
    # the input projection, every column on every rank (gathered from the
    # plan's column split where it has one), then _in_proj's split of it
    zxbcdt = _columns(sf, sp.local(x, sp.act(sf, Pt)), xR,
                      params["in_proj"], None, False)
    z, conv_in, dt_raw = _split_in_proj(zxbcdt, cfg)
    conv_w = sp.weight(sf, params["conv_w"], keep_model=False,
                       model_grad=Rp, dtype=dt_).to(dt_)
    new_cache = None
    if cache is not None:
        state = cache["conv"].redistribute(
            cache["conv"].device_mesh, sp.act(sf)).to_local()
        conv_out, conv_state = _conv1d_causal(conv_in, conv_w, state)
    else:
        conv_out, _ = _conv1d_causal(conv_in, conv_w)
        K = cfg.d_conv
        conv_state = F.pad(conv_in, (0, 0, max(0, (K - 1) - S), 0))[
            :, -(K - 1):]
    xh, Bm, Cm, dt, A = _ssm_inputs(full, conv_out, dt_raw, cfg, dt_)

    def mine(t, dim):
        """This rank's heads of a tensor every rank computed whole."""
        return sp.wrap(sf, t, sp.act(sf, Rp)).redistribute(
            sf.dmesh, sp.act(sf, sp.shard_dim(dim))).to_local()

    nl = nh // M if split else nh
    h0 = r * nl if split else 0
    xh = shard(sf, "ssm_x", sp.wrap(sf, xh, sp.act(sf, Rp))).to_local()
    if split:
        dt, z = mine(dt, 2), mine(z, 2)
        Bm, Cm = (sp.local(sp.wrap(sf, t, sp.act(sf, Rp)), sp.act(sf, Pt))
                  for t in (Bm, Cm))
        A = A[h0:h0 + nl]
    if cache is not None:
        y, h_last = _ssm_step(cache["ssm"].to_local(), xh, dt, A, Bm, Cm)
    else:
        y, h_last = ssd_chunked(xh, dt, A, Bm.float(), Cm.float())

    local = sp.Lazy(D=whole("D", g)[h0:h0 + nl],
                    norm=whole("norm", g)[h0 * hp:(h0 + nl) * hp],
                    out_proj=lambda: sp.weight(
                        sf, params["out_proj"], keep_model=split,
                        model_grad=g, dtype=dt_))
    psum = (lambda t: sp.psum_model(sf, t)) if split and M > 1 else None
    out = sp.join(sf, _out_proj(local, y, xh, z, cfg, dt_, psum),
                  sp.act(sf, g))
    if cache is not None or prefill:
        conv_pl = _cache_pl(sf, "conv", conv_state.shape)
        ssm_pl = [sp.shard_dim(1) if a == "model" and split else p
                  for a, p in zip(sf.mesh.axis_names, sp.act(sf))]
        new_cache = {
            "conv": sp.wrap(sf, conv_state, sp.act(sf)).redistribute(
                sf.dmesh, conv_pl),
            "ssm": sp.wrap(sf, h_last, ssm_pl)}
    return out, new_cache


def _cache_pl(sf, name, local_shape):
    """The placements ``cache_pspecs`` gives a cache leaf ``name`` whose
    local shape (batch split as the activations) is ``local_shape``."""
    from . import sharding_plan as sp
    shape = (local_shape[0] * sp.dp_count(sf),) + tuple(local_shape[1:])
    spec = sp.cache_pspecs(None, {name: torch.empty(shape, device="meta")},
                           shape[0], sf.mesh)[name]
    return sp.placements(sf.mesh, spec, len(shape))


def init_mamba2_params(gen: torch.Generator, cfg,
                       dtype=torch.float32) -> Params:
    """The reference's shapes and scales, drawn from ``gen`` on its
    device."""
    di, st, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    D = cfg.d_model
    dev = gen.device
    conv_dim = di + 2 * st
    proj_out = 2 * di + 2 * st + nh

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def uniform(n):
        return torch.rand((n,), generator=gen, device=dev,
                          dtype=torch.float32)

    lo, hi = math.log(1e-3), math.log(1e-1)
    return {
        "in_proj": normal((D, proj_out)) / math.sqrt(D),
        "conv_w": normal((cfg.d_conv, conv_dim)) * 0.1,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(
            lo + (hi - lo) * uniform(nh)))).to(dtype),
        "A_log": torch.log(1.0 + uniform(nh) * 15.0).to(dtype),
        "D": torch.ones((nh,), dtype=dtype, device=dev),
        "norm": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": normal((di, D)) / math.sqrt(di),
    }
