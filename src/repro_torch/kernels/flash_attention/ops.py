"""Public wrappers of the flash-attention kernel.

``attention`` takes the LM's layout, the contract of the reference's
``models/layers.py::xla_flash``: q (B, S, H, D), k/v (B, T, KH, D), with
``q_offset`` the absolute position of q[:, 0]; it records no gradient.
``flash_attention_lm`` is the same call as an ``autograd.Function``, the
entry the model trains through. ``flash_attention`` is the reference's
public ``flash_attention(q, k, v, scale, causal, window)`` in (B, H, S,
D): it reaches the same kernel through strides (no transposed copy). The
reference's ``bq``/``bk``/``interpret`` knobs are gone: the CUDA kernel's
tiles are its own constants, and the result does not depend on them (the
reference's ``test_block_shape_invariance``).

The differentiable entries save q, k and v and recompute in their
backward (``attention_backward``), as the reference's ``custom_vjp``
recomputes through its oracle; the JAX package has no backward kernel,
and the recompute is plain PyTorch, chunked over query blocks so that
nothing larger than (B, H, block, T) is made.

For CUDA tensors the kernel (``csrc/flash_attention.cu``) runs; for CPU
tensors its plain version (``ref.blocked_attention``) does; there is no
other path. The module's ``launches`` counts kernel launches. Both are
the implementations of one PyTorch custom op, ``repro_torch::
flash_attention(q, k, v, scale, causal, window, q_offset)``, which also
has a fake implementation (the output's shape and type: a fake tensor
has no data pointer, so the dry run's fake world runs the model through
it) and a FLOP formula for ``torch.utils.flop_counter``: 4 · D FLOP for
each (query, key) pair the mask keeps, a pair a query head (``pairs``),
the count ``PERF.md``'s bound for this kernel uses.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import ref as _ref

launches = 0          # kernel launches, for a run to show it used the kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = _build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, *([L] * 12),
                       ctypes.c_float, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, out, *, scale, causal, window, q_offset):
    """Run the kernel on (B, S, H, D)-indexed views (any strides with a
    contiguous last dimension), writing into ``out``."""
    global launches
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if any(t.stride(-1) != 1 for t in (q, k, v, out)):
        raise ValueError("flash attention needs a contiguous last dimension")
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], B, S, T, H, KH, D, *strides, float(scale),
                 int(bool(causal)), int(window), int(q_offset),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(err, "flash_attention")
    launches += 1


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"4-D q and equal k/v expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         "not match (H must be a multiple of KH)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"float32 or bfloat16 q/k/v of one type expected, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"inputs on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda" and D > 256:
        raise ValueError(f"head_dim {D} > 256 is not supported by the kernel")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, causal: bool, window: int,
              q_offset: int) -> torch.Tensor:
    """The CPU implementation: the plain version."""
    return _ref.blocked_attention(q, k, v, scale=scale, causal=causal,
                                  window=window, q_offset=q_offset)


@_flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, scale, causal, window, q_offset):
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel():
        _launch(q, k, v, out, scale=scale, causal=causal, window=window,
                q_offset=q_offset)
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, scale, causal, window, q_offset):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def pairs(S: int, T: int, causal: bool, window: int,
          q_offset: int = 0) -> int:
    """The (query, key) pairs of one head that the mask keeps: query i
    (absolute position q_offset + i) against keys j <= its position when
    causal, and j > position - window with a window."""
    p = q_offset + np.arange(S, dtype=np.int64)
    hi = np.minimum(p, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros(S,
                                                                   np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flops(q_shape, k_shape, v_shape, scale, causal, window, q_offset=0,
           *args, out_shape=None, **kw) -> int:
    B, S, H, D = q_shape
    return 4 * D * B * H * pairs(S, k_shape[1], causal, window, q_offset)


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula
    register_flop_formula(torch.ops.repro_torch.flash_attention)(_flops)


_register_flops()


def attention(q, k, v, *, scale: float, causal: bool, window: int = 0,
              q_offset: int = 0):
    """q (B, S, H, D), k/v (B, T, KH, D) -> (B, S, H, D) in q's type, through
    the custom op ``repro_torch::flash_attention``.

    Inference only: it records no gradient (``flash_attention_lm`` and
    ``flash_attention`` do).
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("attention() records no gradient; use "
                           "flash_attention_lm() for a differentiable "
                           "call")
    return torch.ops.repro_torch.flash_attention(
        q, k, v, float(scale), bool(causal), int(window), int(q_offset))


# query rows of one block of the recompute backward: (B, H, BWD_BLOCK, T)
# f32 tensors, 268 MB each at llama3.2-1b's training shape (B 2, H 32,
# T 4,096)
BWD_BLOCK = 256
BWD_RANGE = "flash_attention_lm.backward"


def _masked_slices(i0, i1, lo, hi, *, causal, window, q_offset, device):
    """The key columns of [lo, hi) where some query of [i0, i1) is masked,
    as (a, b, mask) with a..b relative to lo and ``mask`` (n, b - a) True
    where masked: the causal edge (keys past the block's first query) and
    the window's edge (keys ``window`` or more before its last query).
    Every other column is unmasked for the whole block."""
    spans = []
    if window > 0:
        spans.append([lo, min(hi, q_offset + i1 - window)])
    if causal:
        spans.append([max(lo, q_offset + i0 + 1), hi])
    spans = [x for x in spans if x[0] < x[1]]
    if len(spans) == 2 and spans[1][0] <= spans[0][1]:
        spans = [[spans[0][0], max(spans[0][1], spans[1][1])]]
    out = []
    qp = q_offset + torch.arange(i0, i1, device=device)[:, None]
    for a, b in spans:
        kp = torch.arange(a, b, device=device)[None, :]
        masked = torch.zeros((i1 - i0, b - a), dtype=torch.bool,
                             device=device)
        if causal:
            masked |= kp > qp
        if window > 0:
            masked |= (qp - kp) >= window
        out.append((a - lo, b - lo, masked))
    return out


def attention_backward(q, k, v, g, *, scale: float, causal: bool,
                       window: int = 0, q_offset: int = 0,
                       block: int = 0):
    """Gradients (dq, dk, dv) of ``attention(q, k, v)`` against the
    output's gradient ``g``, in the LM layout and the inputs' types.

    Recomputes in f32, as the reference's ``attention_ref`` does, one block
    of ``block`` (0: ``BWD_BLOCK``) queries at a time, over the keys its
    mask can reach (all T without a mask; a causal block stops at its last
    query, a window starts ``window - 1`` before its first): the masked
    scores s (the mask written only on the columns where it masks
    something), p = softmax(s) with masked entries zero, dV += p^T g,
    dP = g V^T, dS = p (dP - rowsum(p dP)) (``rowsum(p dP)`` is
    ``rowsum(g o)`` of the f32 output, without saving it; softmax and its
    backward are PyTorch's fused row kernels), dQ = scale dS K,
    dK += scale dS^T Q. The G = H / KH query heads of a KV head are rows
    of one batched product, so dK and dV come out summed over each GQA
    group. The largest tensor is (B, H, block, T) f32.
    """
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    block = block or BWD_BLOCK
    f32 = torch.float32
    # (B, KH, G, S, D): a block of queries is G x n rows of one KV head
    qh = q.to(f32).reshape(B, S, KH, G, D).permute(0, 2, 3, 1, 4)
    gh = g.to(f32).reshape(B, S, KH, G, D).permute(0, 2, 3, 1, 4)
    kh = k.to(f32).permute(0, 2, 1, 3).contiguous()       # (B, KH, T, D)
    vh = v.to(f32).permute(0, 2, 1, 3).contiguous()
    dq = torch.zeros((B, KH, G, S, D), dtype=f32, device=q.device)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        n = i1 - i0
        lo = max(0, q_offset + i0 - window + 1) if window > 0 else 0
        hi = min(T, q_offset + i1) if causal else T
        if hi <= lo:                   # every key masked: no gradient
            continue
        edges = _masked_slices(i0, i1, lo, hi, causal=causal, window=window,
                               q_offset=q_offset, device=q.device)
        qb = qh[:, :, :, i0:i1].reshape(B, KH, G * n, D)
        gb = gh[:, :, :, i0:i1].reshape(B, KH, G * n, D)
        kb, vb = kh[:, :, lo:hi], vh[:, :, lo:hi]
        s = (qb @ kb.transpose(-1, -2)).mul_(scale).view(B, KH, G, n, -1)
        for a, b, masked in edges:
            s[..., a:b].masked_fill_(masked, _ref.NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        for a, b, masked in edges:     # a row masked whole: p = 0
            p[..., a:b].masked_fill_(masked, 0.0)
        p = p.view(B, KH, G * n, -1)
        dv[:, :, lo:hi] += p.transpose(-1, -2) @ gb
        dp = gb @ vb.transpose(-1, -2)
        ds = torch._softmax_backward_data(dp, p, -1, f32)
        del p, dp
        dq[:, :, :, i0:i1] = (ds @ kb).mul_(scale).view(B, KH, G, n, D)
        dk[:, :, lo:hi] += (ds.transpose(-1, -2) @ qb).mul_(scale)
        del ds
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _Attention(torch.autograd.Function):
    """``attention`` with the chunked recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(scale=scale, causal=causal, window=window,
                        q_offset=q_offset)
        return attention(q, k, v, **ctx.args)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # a profiler range: the share of a training step spent here
        with torch.profiler.record_function(BWD_RANGE):
            grads = attention_backward(q, k, v, g, **ctx.args)
        return (*grads, None, None, None, None)


def flash_attention_lm(q, k, v, *, scale: float, causal: bool,
                       window: int = 0, q_offset: int = 0):
    """``attention`` (q (B, S, H, D), k/v (B, T, KH, D) -> (B, S, H, D)),
    differentiable: the forward is the same call (kernel 5 on the card),
    the backward ``attention_backward``."""
    return _Attention.apply(q, k, v, scale, causal, window, q_offset)


def flash_attention(q, k, v, scale: float, causal: bool = True,
                    window: int = 0):
    """q (B, H, S, D), k/v (B, KH, S, D) -> (B, H, S, D) in q's type;
    ``flash_attention_lm`` on transposed views (no copy in or out), so
    differentiable the same way."""
    return flash_attention_lm(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), scale=scale, causal=causal,
                              window=window).transpose(1, 2)
