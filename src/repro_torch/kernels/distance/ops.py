"""Public wrappers of the match/valid kernel (``csrc/match_valid.cu``).

``match_valid(a, b)`` counts the (N, M) pairs of two row sets;
``match_valid(a, None)`` is the symmetric (N, N) call, which computes
only the upper triangle of tiles. ``match_valid_groups(msa, index)``
counts G squares in one launch, each over the rows ``index[g]`` (-1 a
pad row that counts nothing). A CUDA tensor launches the kernel on one
of its routes, picked by ``route`` from the shapes and ``n_chars``
alone:

  ``skinny``  min(N, M) <= SKINNY_MAX: one warp per row of the long side
              against the short side in shared memory (single columns)
  ``tc``      1 <= n_chars <= TC_MAX_CHARS: int8 one-hot products on the
              tensor cores (wgmma), 128 x 128 tiles, L split across CTAs
              on small grids
  ``simd``    any other n_chars: byte compares four to a word, 64 x 64
              tiles, L split the same way

A CPU tensor runs the plain version (``ref.py``); there is no other
path. ``launches`` counts kernel launches (``route_launches`` by route).
The distance matrices on top of the counts are ``repro_torch.core.
distance``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref as _ref

SKINNY_MAX = 8        # the skinny route's short side, rows (csrc MAX_SHORT)
TC_MAX_CHARS = 32     # the tensor-core route's alphabet (csrc tc::MAX_CHARS)
ROUTES = ("skinny", "tc", "simd")      # the C entry points' route codes

launches = 0          # kernel launches, for a run to show it used the kernel
route_launches = dict.fromkeys(ROUTES, 0)


def route(n: int, m: int, n_chars: int, *, groups: bool = False) -> str:
    """The route a CUDA call of (n, m) rows (per group) takes."""
    if not groups and min(n, m) <= SKINNY_MAX:
        return "skinny"
    return "tc" if 1 <= n_chars <= TC_MAX_CHARS else "simd"


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # a, b, N, M, L, n_chars, gap, sym, route, match, valid, stream
    "match_valid": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # msa, rows, L, index, G, S, n_chars, gap, route, match, valid, stream
    "match_valid_groups": [_P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P],
}


def _fn(name: str):
    fn = getattr(_build.load("match_valid"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _launched(rt: str) -> None:
    global launches
    launches += 1
    route_launches[rt] += 1


def match_valid(msa_a, msa_b=None, *, n_chars: int, gap_code: int):
    """(N, L) and (M, L) int8 rows -> exact (match, valid) (N, M) int32;
    ``msa_b`` None: the symmetric (N, N) counts of ``msa_a``."""
    sym = msa_b is None
    b = msa_a if sym else msa_b
    if msa_a.dim() != 2 or b.dim() != 2 or msa_a.shape[1] != b.shape[1]:
        raise ValueError(f"(N, L) and (M, L) expected, got "
                         f"{tuple(msa_a.shape)} and {tuple(b.shape)}")
    if msa_a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8 rows expected, got {msa_a.dtype}, {b.dtype}")
    if msa_a.device != b.device:
        raise ValueError(f"inputs on {msa_a.device} and {b.device}")
    if msa_a.device.type == "cpu":
        return _ref.match_valid_ref(msa_a, b, n_chars=n_chars,
                                    gap_code=gap_code)
    if msa_a.device.type != "cuda":
        raise ValueError(f"unsupported device {msa_a.device}")
    if not (msa_a.is_contiguous() and b.is_contiguous()):
        raise ValueError("match_valid needs contiguous rows")
    N, L = msa_a.shape
    M = b.shape[0]
    # the kernel writes every entry (zeroing first where CTAs add up)
    out = torch.empty((2, N, M), dtype=torch.int32, device=msa_a.device)
    match, valid = out[0], out[1]
    if N and M:
        rt = route(N, M, n_chars)
        err = _fn("match_valid")(
            msa_a.data_ptr(), b.data_ptr(), N, M, L, int(n_chars),
            int(gap_code), int(sym), ROUTES.index(rt), match.data_ptr(),
            valid.data_ptr(),
            torch.cuda.current_stream(msa_a.device).cuda_stream)
        _build.check_launch(err, "match_valid")
        _launched(rt)
    return match, valid


def match_valid_groups(msa, index, *, n_chars: int, gap_code: int):
    """(R, L) int8 rows and (G, S) int64 row ids (-1: a pad row) -> exact
    (match, valid) (G, S, S) int32: group g's counts over the rows
    ``msa[index[g]]``, a pad row counting nothing."""
    if msa.dim() != 2 or index.dim() != 2:
        raise ValueError(f"(R, L) rows and (G, S) ids expected, got "
                         f"{tuple(msa.shape)} and {tuple(index.shape)}")
    if msa.dtype != torch.int8 or index.dtype != torch.int64:
        raise TypeError(f"int8 rows and int64 ids expected, got {msa.dtype}, "
                        f"{index.dtype}")
    if msa.device != index.device:
        raise ValueError(f"inputs on {msa.device} and {index.device}")
    G, S = index.shape
    in_range = ((index >= -1) & (index < msa.shape[0])).all()
    if msa.device.type == "cpu":
        if not in_range:
            raise ValueError(f"row ids outside [-1, {msa.shape[0]})")
        return _ref.match_valid_groups_ref(msa, index, n_chars=n_chars,
                                           gap_code=gap_code)
    if msa.device.type != "cuda":
        raise ValueError(f"unsupported device {msa.device}")
    if not (msa.is_contiguous() and index.is_contiguous()):
        raise ValueError("match_valid_groups needs contiguous rows and ids")
    torch._assert_async(in_range)     # checked on the card, no host sync
    out = torch.empty((2, G, S, S), dtype=torch.int32, device=msa.device)
    match, valid = out[0], out[1]
    if G and S:
        rt = route(S, S, n_chars, groups=True)
        err = _fn("match_valid_groups")(
            msa.data_ptr(), msa.shape[0], msa.shape[1], index.data_ptr(), G,
            S, int(n_chars), int(gap_code), ROUTES.index(rt),
            match.data_ptr(), valid.data_ptr(),
            torch.cuda.current_stream(msa.device).cuda_stream)
        _build.check_launch(err, "match_valid_groups")
        _launched(rt)
    return match, valid
