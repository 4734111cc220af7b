"""The AlignEngine backend: batched Gotoh DP plus the shared traceback.

One contract (``BatchAlignment``), as in the reference: align queries
``Q (B, n)`` with lengths ``lens`` against targets and return gap-padded
aligned rows of width ``n + m`` plus per-pair ``ok`` flags. The forward
pass is ``kernels.sw.ops.gotoh_forward`` — the hand-written kernel on a
CUDA tensor, its plain version on a CPU tensor — and the traceback is
``core.pairwise.traceback``. The route is named by the device:

  cuda   the kernel (tensors on the card)
  torch  the plain PyTorch version (tensors on the CPU)

The banded backends of the reference are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import pairwise
from ..kernels.sw import ops as sw_ops

BANDED = ("banded", "banded-pallas")
# reference registry names; in the port each one is the device's route
ALIASES = ("auto", "jnp", "pallas")


class BatchAlignment(NamedTuple):
    score: torch.Tensor      # (B,) f32
    a_row: torch.Tensor      # (B, n+m) int8 gap-padded aligned queries
    b_row: torch.Tensor      # (B, n+m) int8 gap-padded aligned target
    aln_len: torch.Tensor    # (B,) i32 valid leading columns
    ok: torch.Tensor         # (B,) bool; False = needs full-DP fallback


def sw_align_pairs(Q, qlens, T, tlens, sub, *, gap_open, gap_extend,
                   local=False, gap_code=5) -> BatchAlignment:
    """Row i of ``Q`` against row i of ``T`` (per-pair targets)."""
    lens2 = torch.stack([qlens.to(torch.int32), tlens.to(torch.int32)],
                        dim=1)
    fwd = sw_ops.gotoh_forward(Q, T, lens2, sub, gap_open=gap_open,
                               gap_extend=gap_extend, local=local)
    a_row, b_row, k = pairwise.traceback(Q, T, fwd, gap_code)
    return BatchAlignment(fwd.score, a_row, b_row, k,
                          torch.ones(Q.shape[0], dtype=torch.bool,
                                     device=Q.device))


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


def resolve_backend(name: str, device) -> str:
    """The route that runs on ``device``: ``cuda`` (kernel) or ``torch``."""
    if name in BANDED:
        raise NotImplementedError(
            f"align backend {name!r} is not ported yet (ROADMAP.md §1 item 7, "
            "banded alignment)")
    if name not in ALIASES:
        raise ValueError(f"unknown align backend {name!r}; expected one of "
                         f"{sorted(ALIASES + BANDED)}")
    return "cuda" if torch.device(device).type == "cuda" else "torch"
