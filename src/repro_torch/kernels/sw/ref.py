"""Plain PyTorch version of the Gotoh forward kernel (``csrc/sw_forward.cu``).

Same contract as the kernel: the row state freezes past row ``la``, so
even the direction rows beyond a pair's length equal the kernel's (and
the reference Pallas kernel's) byte for byte. The CPU path of
``ops.gotoh_forward`` runs this; on the card it is only the yardstick the
kernel is held against.
"""
from __future__ import annotations

from ...core import pairwise


def gotoh_forward_ref(a, b, lens, sub, *, gap_open: float, gap_extend: float,
                      local: bool):
    """a (B, n) int8, b (B, m) int8, lens (B, 2) i32 -> (dirs rows 1..n
    (B, n, m+1) int8, rec (B, 8) f32 [score, start_i, start_j, state, 0*4])."""
    return pairwise.forward_rows(a, lens[:, 0], b, lens[:, 1], sub, gap_open,
                                 gap_extend, local=local, freeze=True)
