"""Public wrapper of the Gotoh forward kernel: checks, launch, row 0.

``gotoh_forward`` launches ``csrc/sw_forward.cu`` for CUDA tensors and
runs the plain version (``ref.py``) for CPU tensors; there is no other
path. The module's ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.pairwise import ForwardResult, boundary_row, forward_result
from .. import _build
from . import ref as _ref

MAX_SUB = 32
launches = 0          # kernel launches, for a run to show it used the kernel


def _lib():
    lib = _build.load("sw_forward")
    fn = lib.sw_forward
    if fn.argtypes is None:
        P, LL, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
            ctypes.c_float
        fn.argtypes = [P, LL, P, LL, P, P, I, P, P, I, I, I, F, F, I, P]
        fn.restype = ctypes.c_int
    return fn


def _check(a, b, lens, sub):
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"a (B, n) and b (B, m) expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"a and b must be int8, got {a.dtype}, {b.dtype}")
    if lens.shape != (a.shape[0], 2) or lens.dtype != torch.int32:
        raise ValueError(f"lens must be (B, 2) int32, got "
                         f"{tuple(lens.shape)} {lens.dtype}")
    if sub.dim() != 2 or sub.shape[0] != sub.shape[1] \
            or sub.dtype != torch.float32:
        raise ValueError(f"sub must be (S, S) float32, got "
                         f"{tuple(sub.shape)} {sub.dtype}")
    devs = {a.device, b.device, lens.device, sub.device}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def gotoh_forward(a, b, lens, sub, *, gap_open, gap_extend,
                  local=False) -> ForwardResult:
    """Batched Gotoh forward; returns the full (B, n+1, m+1) direction
    tensor (row 0 is the constant boundary row) and the traceback start.

    a: (B, n) int8, b: (B, m) int8 (on the card its rows must be
    contiguous; a batch stride of 0 broadcasts one target), lens: (B, 2)
    int32 ``[[la, lb], ...]``, sub: (S, S) float32.
    """
    global launches
    _check(a, b, lens, sub)
    if a.device.type == "cpu":
        return forward_result(*_ref.gotoh_forward_ref(
            a, b, lens, sub, gap_open=gap_open, gap_extend=gap_extend,
            local=local))
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    B, n = a.shape
    m = b.shape[1]
    S = sub.shape[0]
    if S > MAX_SUB:
        raise ValueError(f"substitution matrix of size {S} > {MAX_SUB}")
    if n > 0 and a.stride(1) != 1:
        raise ValueError("a's rows must be contiguous")
    if m > 0 and b.stride(1) != 1:
        raise ValueError("b's rows must be contiguous")
    if not lens.is_contiguous() or not sub.is_contiguous():
        raise ValueError("lens and sub must be contiguous")
    if m + 1 > 16 * 1024:
        raise ValueError(f"target width {m} exceeds the kernel's 16383")
    dirs = torch.empty((B, n + 1, m + 1), dtype=torch.int8, device=a.device)
    rec = torch.empty((B, 8), dtype=torch.float32, device=a.device)
    if B:
        dirs[:, 0] = boundary_row(m, a.device)
        err = _lib()(a.data_ptr(), a.stride(0), b.data_ptr(),
                     b.stride(0) if B > 1 else 0, lens.data_ptr(),
                     sub.data_ptr(), S, dirs.data_ptr(), rec.data_ptr(), B,
                     n, m, float(gap_open), float(gap_extend), int(local),
                     torch.cuda.current_stream(a.device).cuda_stream)
        _build.check_launch(err, "sw_forward")
        launches += 1
    return ForwardResult(dirs, rec[:, 0], rec[:, 1].to(torch.int32),
                         rec[:, 2].to(torch.int32), rec[:, 3].to(torch.int32))

