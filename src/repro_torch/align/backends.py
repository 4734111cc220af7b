"""The AlignEngine backends: batched Gotoh DP, full or banded.

One contract (``BatchAlignment``), as in the reference: align queries
``Q (B, n)`` with lengths ``lens`` against targets and return gap-padded
aligned rows of width ``n + m`` plus per-pair ``ok`` flags (False = the
band overflowed and the pair needs a full-DP re-alignment). Every
forward pass is a wrapper that launches a hand-written kernel on a CUDA
tensor and runs its plain version on a CPU tensor:

  full DP   ``kernels.sw.ops.gotoh_forward`` + ``core.pairwise.traceback``
            (``sw_align_*``); global or local
  banded    ``kernels.banded.ops.banded_forward`` + the banded traceback
            (``banded_align_*``); global only
  fused     ``kernels.banded.ops.banded_pairs_fused``: banded forward and
            traceback in one kernel (``banded_fused_align_pairs``)

The reference's names map onto these routes: ``auto``/``jnp``/``pallas``
are the full DP; ``banded`` and ``banded-pallas`` are the banded route
(on the pairs path ``banded`` takes the banded forward + traceback and
``banded-pallas`` the fused kernel, as in the reference). The route a
name runs is named by the device (``resolve_backend``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import pairwise
from ..kernels.banded import ops as banded_ops
from ..kernels.sw import ops as sw_ops
from . import banded as banded_mod

BANDED = ("banded", "banded-pallas")
# the most direction bytes one forward call may write, full DP or banded
# (8 GiB: the 16S main path's 3,735 x 1,494 x 1,494 fallback batch is one
# call)
DIRS_BUDGET = 8 << 30
# reference registry names; in the port each one is the device's route
ALIASES = ("auto", "jnp", "pallas")


class BatchAlignment(NamedTuple):
    score: torch.Tensor      # (B,) f32
    a_row: torch.Tensor      # (B, n+m) int8 gap-padded aligned queries
    b_row: torch.Tensor      # (B, n+m) int8 gap-padded aligned target
    aln_len: torch.Tensor    # (B,) i32 valid leading columns
    ok: torch.Tensor         # (B,) bool; False = needs full-DP fallback


def _in_chunks(align, per_pair: int, Q, qlens, T, tlens) -> BatchAlignment:
    """``align(Q, qlens, T, tlens)`` over chunks of pairs whose direction
    bytes (``per_pair`` each) stay within ``DIRS_BUDGET``, concatenated;
    one call when the batch fits. Each pair's result is its own, so the
    results are the same at any chunk size."""
    B = Q.shape[0]
    step = max(DIRS_BUDGET // max(per_pair, 1), 1)
    if B <= step:
        return align(Q, qlens, T, tlens)
    parts = [align(Q[c:c + step], qlens[c:c + step], T[c:c + step],
                   tlens[c:c + step]) for c in range(0, B, step)]
    return BatchAlignment(*(torch.cat(f) for f in zip(*parts)))


def sw_align_pairs(Q, qlens, T, tlens, sub, *, gap_open, gap_extend,
                   local=False, gap_code=5) -> BatchAlignment:
    """Row i of ``Q`` against row i of ``T`` (per-pair targets).

    The full DP writes (n+1)·(m+1) direction bytes per pair; a batch past
    ``DIRS_BUDGET`` runs in chunks of pairs (``_in_chunks``), one forward
    and one traceback each.
    """
    def align(Q, qlens, T, tlens):
        lens2 = torch.stack([qlens.to(torch.int32), tlens.to(torch.int32)],
                            dim=1)
        fwd = sw_ops.gotoh_forward(Q, T, lens2, sub, gap_open=gap_open,
                                   gap_extend=gap_extend, local=local)
        a_row, b_row, k = pairwise.traceback(Q, T, fwd, gap_code)
        return BatchAlignment(fwd.score, a_row, b_row, k,
                              torch.ones(Q.shape[0], dtype=torch.bool,
                                         device=Q.device))
    return _in_chunks(align, (Q.shape[1] + 1) * (T.shape[1] + 1), Q, qlens,
                      T, tlens)


def sw_align_batch(Q, lens, b, lb, sub, *, gap_open, gap_extend,
                   local=False, gap_code=5) -> BatchAlignment:
    """Every query against one broadcast target ``b (m,)`` of length lb
    (a batch stride of 0: the target is not copied per pair)."""
    B = Q.shape[0]
    T = b[None, :].expand(B, b.shape[0])
    tlens = torch.full((B,), int(lb), dtype=torch.int32, device=Q.device)
    return sw_align_pairs(Q, lens, T, tlens, sub, gap_open=gap_open,
                          gap_extend=gap_extend, local=local,
                          gap_code=gap_code)


def banded_align_pairs(Q, qlens, T, tlens, sub, *, gap_open, gap_extend,
                       band=64, gap_code=5) -> BatchAlignment:
    """Banded forward kernel + the banded traceback, per-pair targets.

    The forward writes n·band direction bytes per pair; a batch past
    ``DIRS_BUDGET`` runs in chunks of pairs (``_in_chunks``).
    """
    def align(Q, qlens, T, tlens):
        lens2 = torch.stack([qlens.to(torch.int32), tlens.to(torch.int32)],
                            dim=1)
        fwd = banded_ops.banded_forward(Q, T, lens2, sub, gap_open=gap_open,
                                        gap_extend=gap_extend, band=band)
        a_row, b_row, k, ok = banded_mod.banded_traceback(Q, T, fwd,
                                                          gap_code, band=band)
        return BatchAlignment(fwd.score, a_row, b_row, k, ok)
    return _in_chunks(align, Q.shape[1] * band, Q, qlens, T, tlens)


def banded_align_batch(Q, lens, b, lb, sub, *, gap_open, gap_extend,
                       band=64, gap_code=5) -> BatchAlignment:
    """Every query against one broadcast target, banded (batch stride 0)."""
    B = Q.shape[0]
    T = b[None, :].expand(B, b.shape[0])
    tlens = torch.full((B,), int(lb), dtype=torch.int32, device=Q.device)
    return banded_align_pairs(Q, lens, T, tlens, sub, gap_open=gap_open,
                              gap_extend=gap_extend, band=band,
                              gap_code=gap_code)


def banded_fused_align_pairs(Q, qlens, T, tlens, sub, *, gap_open,
                             gap_extend, band=64, gap_code=5
                             ) -> BatchAlignment:
    """The fused banded kernel: score and traceback in one launch."""
    lens2 = torch.stack([qlens.to(torch.int32), tlens.to(torch.int32)],
                        dim=1)
    return BatchAlignment(*banded_ops.banded_pairs_fused(
        Q, T, lens2, sub, gap_open=gap_open, gap_extend=gap_extend,
        band=band, gap_code=gap_code))


def resolve_backend(name: str, device) -> str:
    """The route ``name`` runs on ``device``: ``cuda`` / ``torch`` (full
    DP, kernel / plain) or ``cuda-banded`` / ``torch-banded``."""
    if name not in ALIASES + BANDED:
        raise ValueError(f"unknown align backend {name!r}; expected one of "
                         f"{sorted(ALIASES + BANDED)}")
    route = "cuda" if torch.device(device).type == "cuda" else "torch"
    return route + "-banded" if name in BANDED else route
