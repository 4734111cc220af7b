"""Public wrappers of the banded kernels: checks, launch plan, launch,
plain version.

``banded_forward`` launches ``csrc/banded_forward.cu`` and
``banded_pairs_fused`` launches ``csrc/banded_fused.cu`` for CUDA
tensors; for CPU tensors both run the plain version (``ref.py``). There
is no other path. Both kernels take any band W in 1..``MAX_BAND`` on two
routes: up to ``WARP_MAX_BAND`` a pair a warp, ``PAIRS_PER_CTA`` a CTA;
wider bands a pair a CTA of 512 threads, the band's rows in shared memory
(``pairs_per_cta``). Each pair's sequences are staged in shared memory in
windows that follow the band, so sequences of any length fit. Kernel 3
takes one pass over B. The fused kernel keeps each pair's (n, W)
direction band at 4 bits a cell (rows of ``band_pitch`` bytes) and its
walk's moves in a device workspace of one slot a pair slot of a
persistent grid, as many CTAs as the card holds at once and no more than
``WORKSPACE_BUDGET`` bytes of slots (``fused_plan``), so the workspace
does not grow with B. ``forward_launches`` and ``fused_launches`` count
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from . import ref as _ref
from .ref import BandedForward

MAX_SUB = 32
MAX_BAND = 16384           # csrc/banded_row.cuh: MAX_WIDE_W
WARP_MAX_BAND = 1024       # the warp route's widest band (MAX_W)
PAIRS_PER_CTA = 8          # a pair a warp (csrc/banded_row.cuh: PAIRS)
# the most bytes of kernel 4's workspace one call takes; a slot larger
# than this still gets one CTA
WORKSPACE_BUDGET = 2 << 30

forward_launches = 0    # kernel launches, for a run to show it used them
fused_launches = 0


class FusedPlan(NamedTuple):
    grid: int               # CTAs of pairs_per_cta(band) pair slots
    slot_bytes: int         # workspace a pair slot: its band, its moves
    workspace_bytes: int    # grid * pairs_per_cta(band) * slot_bytes


def pairs_per_cta(band: int) -> int:
    """Pairs a CTA of either kernel holds: ``PAIRS_PER_CTA`` on the warp
    route (W <= ``WARP_MAX_BAND``), one on the wide route."""
    return PAIRS_PER_CTA if band <= WARP_MAX_BAND else 1


def cells_per_lane(band: int) -> int:
    """K, the band cells a lane holds: the least power of two with
    32 K >= band (on the wide route a warp's 32 K cells are spread over
    its 32 threads' shares)."""
    K = 1
    while 32 * K < band:
        K *= 2
    return K


def band_pitch(band: int) -> int:
    """Bytes of a packed direction row of the fused kernel (32 K cells at
    4 bits, on either route)."""
    return 16 * cells_per_lane(band)


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def fused_plan(B: int, n: int, m: int, band: int, ctas: int) -> FusedPlan:
    """Kernel 4's launch on a card that holds ``ctas`` of its CTAs at once
    (SMs x ``fused_kernel_attrs``' CTAs an SM): a persistent grid of at
    most that many CTAs and at most ``WORKSPACE_BUDGET`` bytes of slots
    (at least one CTA), pair slot p serving pairs p, p + slots, ..., each
    slot's workspace its packed band, then its walk's 2-bit moves (16 a
    word). ``csrc/banded_fused.cu::fused_slot_bytes`` is the same layout;
    the kernel's entry refuses a workspace smaller than it. Each pair's
    result is its own, so any grid gives the same results."""
    slot = n * band_pitch(band) + _round16((n + m + 15) // 16 * 4)
    per = pairs_per_cta(band)
    grid = max(1, min(_cdiv(B, per), ctas, WORKSPACE_BUDGET // (per * slot)))
    return FusedPlan(grid, slot, grid * per * slot)


_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float


def _fn(name, argtypes, lib=None):
    fn = getattr(_build.load(lib or name), name)
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


def _cuda_args(a, b, lens, sub, pad=0):
    """Device checks and the common leading C arguments; pads an empty
    target to one column of ``pad`` (no forward cell reads it when
    lb == 0; the traceback's clamped read finds the gap there, as the
    reference's does)."""
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    S = sub.shape[0]
    if S > MAX_SUB:
        raise ValueError(f"substitution matrix of size {S} > {MAX_SUB}")
    if b.shape[1] == 0:
        b = torch.full((b.shape[0], 1), pad, dtype=torch.int8,
                       device=b.device)
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


def banded_pairs_fused(a, b, lens, sub, *, gap_open, gap_extend, band,
                       gap_code: int = 5):
    """Fused banded score + traceback for a batch of pairs (global).

    Inputs as ``banded_forward``. Returns (score (B,) f32, a_row (B, n+m)
    int8, b_row (B, n+m) int8, aln_len (B,) i32, ok (B,) bool) — the
    ``BatchAlignment`` field order. On the card no direction matrix is
    written to device memory beyond the fixed workspace of ``fused_plan``.
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
    b, head = _cuda_args(a, b, lens, sub, pad=gap_code)
    B, n = a.shape
    m = b.shape[1]
    dev = a.device
    a_row = torch.empty((B, m + n), dtype=torch.int8, device=dev)
    b_row = torch.empty((B, m + n), dtype=torch.int8, device=dev)
    rec = torch.zeros((B, 8), dtype=torch.float32, device=dev)
    if B:
        plan = fused_plan(B, n, m, int(band),
                          resident_ctas(dev, int(band), head[-1]))
        work = torch.empty(plan.workspace_bytes, dtype=torch.uint8,
                           device=dev)
        fn = _fn("banded_fused", [_P, _LL, _P, _LL, _P, _P, _I, _P, _P, _P,
                                  _P, _LL, _I, _I, _I, _I, _F, _F, _I, _I,
                                  _P])
        err = fn(*head, a_row.data_ptr(), b_row.data_ptr(), rec.data_ptr(),
                 work.data_ptr(), plan.workspace_bytes, B, n, m, int(band),
                 float(gap_open), float(gap_extend), int(gap_code),
                 plan.grid, torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(err, "banded_fused")
        fused_launches += 1
    # an empty target was padded to one column; the rows keep n + m
    return (rec[:, 0], a_row[:, :out_len], b_row[:, :out_len],
            rec[:, 4].to(torch.int32), rec[:, 5] > 0.5)


def _attrs(entry: str, lib: str, band: int, S: int) -> dict:
    fn = _fn(entry, [_I, _I, _P, _P, _P], lib)
    regs, local, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(int(band), int(S), ctypes.byref(regs), ctypes.byref(local),
             ctypes.byref(ctas))
    _build.check_launch(err, entry)
    return dict(registers=regs.value, local_bytes=local.value,
                ctas_per_sm=ctas.value)


def fused_kernel_attrs(band: int, S: int) -> dict:
    """Registers and local-memory (spill) bytes a thread of kernel 4's
    instantiation for ``band`` uses, and the CTAs of it an SM holds at
    once with an S x S table (card only)."""
    return _attrs("banded_fused_attrs", "banded_fused", band, S)


def forward_kernel_attrs(band: int, S: int) -> dict:
    """The same for kernel 3's instantiation for ``band`` (card only)."""
    return _attrs("banded_forward_attrs", "banded_forward", band, S)


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(band_cells: int, S: int, device: int) -> int:
    with torch.cuda.device(device):
        return fused_kernel_attrs(32 * band_cells, S)["ctas_per_sm"]


def resident_ctas(dev, band: int, S: int) -> int:
    """Kernel 4's CTAs that the card ``dev`` holds at once."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * _ctas_per_sm(cells_per_lane(band), S, index)
