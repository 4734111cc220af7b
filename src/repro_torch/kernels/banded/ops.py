"""Public wrappers of the banded kernels: checks, launch, plain version.

``banded_forward`` launches ``csrc/banded_forward.cu`` and
``banded_pairs_fused`` launches ``csrc/banded_fused.cu`` for CUDA
tensors; for CPU tensors both run the plain version (``ref.py``). There
is no other path. ``forward_launches`` and ``fused_launches`` count
kernel launches; ``fused_variant_launches`` splits the fused ones by
where the direction band lived (``smem`` or ``global``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref as _ref
from .ref import BandedForward

MAX_SUB = 32
MAX_BAND = 1024
# the fused kernel keeps the (n, W) direction band in shared memory up to
# this many bytes (the rest of its shared memory is under 27 KB, inside
# the H100's 227 KB per block); larger bands go to a device workspace
FUSED_SMEM_BAND_BYTES = 200 * 1024

forward_launches = 0    # kernel launches, for a run to show it used them
fused_launches = 0
fused_variant_launches = {"smem": 0, "global": 0}


_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float


def _fn(name, argtypes):
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(a, b, lens, sub, band):
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
    if not 1 <= int(band) <= MAX_BAND:
        raise ValueError(f"band {band} outside the kernels' 1..{MAX_BAND}")
    devs = {a.device, b.device, lens.device, sub.device}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def _cuda_args(a, b, lens, sub):
    """Device checks and the common leading C arguments; pads an empty
    target to one column (no cell reads it when lb == 0)."""
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    S = sub.shape[0]
    if S > MAX_SUB:
        raise ValueError(f"substitution matrix of size {S} > {MAX_SUB}")
    if b.shape[1] == 0:
        b = torch.zeros((b.shape[0], 1), dtype=torch.int8, device=b.device)
    if a.shape[1] > 0 and a.stride(1) != 1:
        raise ValueError("a's rows must be contiguous")
    if b.stride(1) != 1:
        raise ValueError("b's rows must be contiguous")
    if not lens.is_contiguous() or not sub.is_contiguous():
        raise ValueError("lens and sub must be contiguous")
    B = a.shape[0]
    return b, [a.data_ptr(), a.stride(0), b.data_ptr(),
               b.stride(0) if B > 1 else 0, lens.data_ptr(), sub.data_ptr(),
               S]


def banded_forward(a, b, lens, sub, *, gap_open, gap_extend,
                   band) -> BandedForward:
    """Batched banded Gotoh forward (global).

    a: (B, n) int8, b: (B, m) int8 (on the card its rows must be
    contiguous; a batch stride of 0 broadcasts one target), lens: (B, 2)
    int32 ``[[la, lb], ...]`` with la <= n and lb <= m, sub: (S, S)
    float32. Returns ``BandedForward`` with dirs (B, n, band) int8 and
    per-pair score, start (la, lb), start state and edge flag.
    """
    global forward_launches
    _check(a, b, lens, sub, band)
    if a.device.type == "cpu":
        return _ref.banded_forward(a, lens[:, 0], b, lens[:, 1], sub,
                                        gap_open, gap_extend, band=band)
    b, head = _cuda_args(a, b, lens, sub)
    B, n = a.shape
    m = b.shape[1]
    dirs = torch.empty((B, n, band), dtype=torch.int8, device=a.device)
    rec = torch.zeros((B, 8), dtype=torch.float32, device=a.device)
    if B:
        fn = _fn("banded_forward", [_P, _LL, _P, _LL, _P, _P, _I, _P, _P, _I,
                                    _I, _I, _I, _F, _F, _P])
        err = fn(*head, dirs.data_ptr(), rec.data_ptr(), B, n, m, int(band),
                 float(gap_open), float(gap_extend),
                 torch.cuda.current_stream(a.device).cuda_stream)
        _build.check_launch(err, "banded_forward")
        forward_launches += 1
    i32 = torch.int32
    return BandedForward(dirs, rec[:, 0], rec[:, 1].to(i32),
                         rec[:, 2].to(i32), rec[:, 3].to(i32), rec[:, 4] > 0.5)


def fused_variant(n: int, band: int) -> str:
    """Where the fused kernel keeps the (n, band) direction band."""
    return "smem" if n * band <= FUSED_SMEM_BAND_BYTES else "global"


def banded_pairs_fused(a, b, lens, sub, *, gap_open, gap_extend, band,
                       gap_code: int = 5):
    """Fused banded score + traceback for a batch of pairs (global).

    Inputs as ``banded_forward``. Returns (score (B,) f32, a_row (B, n+m)
    int8, b_row (B, n+m) int8, aln_len (B,) i32, ok (B,) bool) — the
    ``BatchAlignment`` field order. On the card no direction matrix is
    written to device memory when the band fits in shared memory.
    """
    global fused_launches
    _check(a, b, lens, sub, band)
    if a.device.type == "cpu":
        fwd = _ref.banded_forward(a, lens[:, 0], b, lens[:, 1], sub,
                                       gap_open, gap_extend, band=band)
        a_row, b_row, k, ok = _ref.banded_traceback(a, b, fwd, gap_code,
                                                         band=band)
        return fwd.score, a_row, b_row, k, ok
    out_len = a.shape[1] + b.shape[1]
    b, head = _cuda_args(a, b, lens, sub)
    B, n = a.shape
    m = b.shape[1]
    dev = a.device
    a_row = torch.empty((B, m + n), dtype=torch.int8, device=dev)
    b_row = torch.empty((B, m + n), dtype=torch.int8, device=dev)
    rec = torch.zeros((B, 8), dtype=torch.float32, device=dev)
    variant = fused_variant(n, int(band))
    work = (torch.empty((B, n, band), dtype=torch.int8, device=dev)
            if variant == "global" else None)
    if B:
        fn = _fn("banded_fused", [_P, _LL, _P, _LL, _P, _P, _I, _P, _P, _P,
                                  _P, _I, _I, _I, _I, _F, _F, _I, _I, _P])
        err = fn(*head, a_row.data_ptr(), b_row.data_ptr(), rec.data_ptr(),
                 work.data_ptr() if work is not None else None, B, n, m,
                 int(band), float(gap_open), float(gap_extend),
                 int(gap_code), int(variant == "smem"),
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(err, "banded_fused")
        fused_launches += 1
        fused_variant_launches[variant] += 1
    # an empty target was padded to one column; the rows keep n + m
    return (rec[:, 0], a_row[:, :out_len], b_row[:, :out_len],
            rec[:, 4].to(torch.int32), rec[:, 5] > 0.5)
