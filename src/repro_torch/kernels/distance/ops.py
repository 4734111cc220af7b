"""Public wrapper of the match/valid kernel.

``match_valid`` launches ``csrc/match_valid.cu`` for CUDA tensors and
runs the plain version (``ref.py``) for CPU tensors; there is no other
path. The module's ``launches`` counts kernel launches. The distance
matrix on top of the counts is ``repro_torch.core.distance``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref as _ref

launches = 0          # kernel launches, for a run to show it used the kernel


def _lib():
    fn = _build.load("match_valid").match_valid
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, I, I, I, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def match_valid(msa_a, msa_b, *, n_chars: int, gap_code: int):
    """(N, L) and (M, L) int8 rows -> exact (match, valid) (N, M) int32."""
    global launches
    if msa_a.dim() != 2 or msa_b.dim() != 2 \
            or msa_a.shape[1] != msa_b.shape[1]:
        raise ValueError(f"(N, L) and (M, L) expected, got "
                         f"{tuple(msa_a.shape)} and {tuple(msa_b.shape)}")
    if msa_a.dtype != torch.int8 or msa_b.dtype != torch.int8:
        raise TypeError(f"int8 rows expected, got {msa_a.dtype}, "
                        f"{msa_b.dtype}")
    if msa_a.device != msa_b.device:
        raise ValueError(f"inputs on {msa_a.device} and {msa_b.device}")
    if msa_a.device.type == "cpu":
        return _ref.match_valid_ref(msa_a, msa_b, n_chars=n_chars,
                                    gap_code=gap_code)
    if msa_a.device.type != "cuda":
        raise ValueError(f"unsupported device {msa_a.device}")
    if not (msa_a.is_contiguous() and msa_b.is_contiguous()):
        raise ValueError("match_valid needs contiguous rows")
    N, L = msa_a.shape
    M = msa_b.shape[0]
    match = torch.zeros((N, M), dtype=torch.int32, device=msa_a.device)
    valid = torch.zeros((N, M), dtype=torch.int32, device=msa_a.device)
    if N and M:
        err = _lib()(msa_a.data_ptr(), msa_b.data_ptr(), N, M, L,
                     int(n_chars), int(gap_code), match.data_ptr(),
                     valid.data_ptr(),
                     torch.cuda.current_stream(msa_a.device).cuda_stream)
        _build.check_launch(err, "match_valid")
        launches += 1
    return match, valid


