"""Public wrapper of the Gotoh forward kernel: checks, launch plan,
launch, row 0.

``gotoh_forward`` launches ``csrc/sw_forward.cu`` for CUDA tensors and
runs the plain version (``ref.py``) for CPU tensors; there is no other
path. The kernel runs a pair a warp, ``PAIRS_PER_CTA`` a CTA, on a
persistent grid of as many CTAs as the card holds at once; a target
wider than one strip of 32 x ``MAX_COLS`` columns is swept in strips whose
right edges pass through one workspace slot a pair slot, so any width
runs and the workspace does not grow with B (``sw_plan``). The module's
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...core.pairwise import ForwardResult, boundary_row, forward_result
from .. import _build
from . import ref as _ref

MAX_SUB = 32
MAX_COLS = 12          # columns a lane (csrc/sw_forward.cu: MAX_C)
PAIRS_PER_CTA = 4      # a pair a warp (csrc/sw_forward.cu: WARPS)
EDGE_BYTES = 16        # a strip's right edge a row: (M, Ix, Iy, pad) f32
launches = 0          # kernel launches, for a run to show it used the kernel

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float


class SwPlan(NamedTuple):
    cols_per_lane: int      # C: a lane's columns in a strip
    strips: int             # strips of 32 C columns, left to right
    grid: int               # CTAs of PAIRS_PER_CTA pair slots
    slot_bytes: int         # workspace a pair slot: a strip edge entry a row
    workspace_bytes: int    # grid * PAIRS_PER_CTA * slot_bytes


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def strip_layout(m: int):
    """(C, strips) for a target of m + 1 columns: as few strips of at most
    32 x MAX_COLS columns as cover them, then the least C with
    32 C strips >= m + 1 (``csrc/sw_forward.cu``: sw_cols, sw_strips)."""
    strips = _cdiv(m + 1, 32 * MAX_COLS)
    return _cdiv(m + 1, 32 * strips), strips


def sw_plan(B: int, n: int, m: int, ctas: int) -> SwPlan:
    """Kernel 1's launch on a card that holds ``ctas`` of its CTAs at once
    (SMs x ``sw_kernel_attrs``' CTAs an SM): a persistent grid of at most
    that many CTAs, pair slot p serving pairs p, p + slots, ...; when the
    target takes more than one strip, each slot's workspace holds one
    strip edge entry a DP row (``csrc/sw_forward.cu::sw_slot_bytes``; the
    kernel's entry refuses a smaller workspace)."""
    C, strips = strip_layout(m)
    slot = EDGE_BYTES * n if strips > 1 else 0
    grid = max(1, min(_cdiv(B, PAIRS_PER_CTA), ctas))
    return SwPlan(C, strips, grid, slot, grid * PAIRS_PER_CTA * slot)


def _fn(name, argtypes):
    fn = getattr(_build.load("sw_forward"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def sw_kernel_attrs(m: int, local: bool, S: int) -> dict:
    """Registers and local-memory (spill) bytes a thread of the kernel's
    instantiation for target width ``m`` uses, and the CTAs of it an SM
    holds at once with an S x S table (card only)."""
    fn = _fn("sw_forward_attrs", [_I, _I, _I, _P, _P, _P])
    regs, local_b, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(int(m), int(local), int(S), ctypes.byref(regs),
             ctypes.byref(local_b), ctypes.byref(ctas))
    _build.check_launch(err, "sw_forward_attrs")
    return dict(registers=regs.value, local_bytes=local_b.value,
                ctas_per_sm=ctas.value)


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(cols: int, local: bool, S: int, device: int) -> int:
    with torch.cuda.device(device):
        return sw_kernel_attrs(32 * cols - 1, local, S)["ctas_per_sm"]


def resident_ctas(dev, m: int, local: bool, S: int) -> int:
    """Kernel 1's CTAs for target width ``m`` and an S x S table that the
    card ``dev`` holds at once."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * _ctas_per_sm(strip_layout(m)[0], bool(local), int(S), index)


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
    int32 ``[[la, lb], ...]``, sub: (S, S) float32. On the card the scores
    (``sub``, the gap penalties) must be integer-valued, as every caller's
    are: the kernel's exactness rests on it (``csrc/sw_forward.cu``).
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
    if not (float(gap_open).is_integer() and float(gap_extend).is_integer()):
        raise ValueError(f"the kernel takes integer-valued scores, got gaps "
                         f"{gap_open}, {gap_extend}")
    dirs = torch.empty((B, n + 1, m + 1), dtype=torch.int8, device=a.device)
    rec = torch.empty((B, 8), dtype=torch.float32, device=a.device)
    if B:
        dirs[:, 0] = boundary_row(m, a.device)
        plan = sw_plan(B, n, m, resident_ctas(a.device, m, local, S))
        work = torch.empty(plan.workspace_bytes, dtype=torch.uint8,
                           device=a.device)
        fn = _fn("sw_forward", [_P, _LL, _P, _LL, _P, _P, _I, _P, _P, _P,
                                _LL, _I, _I, _I, _F, _F, _I, _I, _P])
        err = fn(a.data_ptr(), a.stride(0), b.data_ptr(),
                 b.stride(0) if B > 1 else 0, lens.data_ptr(),
                 sub.data_ptr(), S, dirs.data_ptr(), rec.data_ptr(),
                 work.data_ptr(), plan.workspace_bytes, B, n, m,
                 float(gap_open), float(gap_extend), int(local), plan.grid,
                 torch.cuda.current_stream(a.device).cuda_stream)
        _build.check_launch(err, "sw_forward")
        launches += 1
    return ForwardResult(dirs, rec[:, 0], rec[:, 1].to(torch.int32),
                         rec[:, 2].to(torch.int32), rec[:, 3].to(torch.int32))

