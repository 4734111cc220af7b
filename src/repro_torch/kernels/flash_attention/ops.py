"""Public wrappers of the flash-attention kernel.

``attention`` takes the LM's layout, the contract of the reference's
``models/layers.py::xla_flash``: q (B, S, H, D), k/v (B, T, KH, D), with
``q_offset`` the absolute position of q[:, 0]. ``flash_attention`` is the
reference's public ``flash_attention(q, k, v, scale, causal, window)`` in
(B, H, S, D): it reaches the same kernel through strides (no transposed
copy), and its backward recomputes through ``ref.attention_ref``, as the
reference's ``custom_vjp`` does. The reference's ``bq``/``bk``/``interpret``
knobs are gone: the CUDA kernel's tiles are its own constants, and the
result does not depend on them (the reference's
``test_block_shape_invariance``).

For CUDA tensors the kernel (``csrc/flash_attention.cu``) runs; for CPU
tensors its plain version (``ref.blocked_attention``) does; there is no
other path. The module's ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

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


def attention(q, k, v, *, scale: float, causal: bool, window: int = 0,
              q_offset: int = 0):
    """q (B, S, H, D), k/v (B, T, KH, D) -> (B, S, H, D) in q's type.

    Inference only: it records no gradient (``flash_attention`` does).
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("attention() records no gradient; use "
                           "flash_attention() for a differentiable call")
    if q.device.type == "cpu":
        return _ref.blocked_attention(q, k, v, scale=scale, causal=causal,
                                      window=window, q_offset=q_offset)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel():
        _launch(q, k, v, out, scale=scale, causal=causal, window=window,
                q_offset=q_offset)
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, causal, window)
        # the (B, S, H, D) entry on transposed views: no copy in or out
        return attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), scale=scale, causal=causal,
                         window=window).transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale, causal, window = ctx.args
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _ref.attention_ref(*qkv, scale=scale, causal=causal,
                                     window=window)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None, None, None)


def flash_attention(q, k, v, scale: float, causal: bool = True,
                    window: int = 0):
    """q (B, H, S, D), k/v (B, KH, S, D) -> (B, H, S, D) in q's type;
    differentiable (the backward recomputes through ``ref.attention_ref``)."""
    return _FlashAttention.apply(q, k, v, scale, causal, window)
