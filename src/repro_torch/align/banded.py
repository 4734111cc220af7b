"""Banded Gotoh DP: O(n·W) direction storage instead of O(n·m).

The port of ``repro.align.banded``, batched over pairs. HAlign-II's
inputs are highly similar, so the optimal path hugs the (0,0)→(la,lb)
diagonal; only a width-W band of cells around that diagonal is kept per
row.

Band geometry: row ``i`` stores absolute columns ``j ∈ [lo_i, lo_i+W)``
with ``lo_i = floor(i·lb/la) - W//2`` (for ``la == 0`` the band parks on
``j = lb``). The global end cell ``(la, lb)`` is always at offset
``W//2``. Cells outside the band are NEG; with ``W ≥ 2·lb + 2`` the
recurrence equals the full ``pairwise.gotoh_forward``.

Band overflow is detected by forward "edge pressure" (a competitive cell
in an exit zone of a live row) and by the traceback (a walk that leaves
the band or touches a band edge next to real cells, or a NEG-degenerate
score); flagged pairs come back with ``ok = False`` and the engine
re-aligns them with the full DP. Global alignment only: the engine routes
``local=True`` to the full DP.

The row recurrence and the traceback step are the shared band math in
``kernels.banded.ref``, which is also the plain version of both banded
kernels; ``banded_forward`` and ``banded_traceback`` are re-exported from
there under the reference's names and signatures.
"""
from __future__ import annotations

from ..core.pairwise import AlignResult
from ..kernels.banded.ref import (BandedForward, band_lo, band_row_init,
                                  band_row_update, banded_forward,
                                  banded_traceback, edge_pressure,
                                  trace_step_math)

__all__ = ["BandedForward", "band_lo", "band_row_init", "band_row_update",
           "edge_pressure", "trace_step_math", "banded_forward",
           "banded_traceback", "banded_align_pair"]


def banded_align_pair(a, la, b, lb, sub, *, gap_open, gap_extend, band,
                      gap_code=5):
    """Banded counterpart of ``pairwise.align_pair``; extra ``ok`` output."""
    fwd = banded_forward(a, la, b, lb, sub, gap_open, gap_extend, band=band)
    a_row, b_row, k, ok = banded_traceback(a, b, fwd, gap_code, band=band)
    return AlignResult(fwd.score, a_row, b_row, k, fwd.start_i,
                       fwd.start_j), ok
