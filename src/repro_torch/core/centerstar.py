"""Center-star MSA assembly: the paper's two MapReduce stages, batched.

Stage map(1): every sequence is pairwise-aligned to the broadcast center.
Stage reduce(1): the per-pair insert-space profiles are merged with an
elementwise ``max``. Stage map(2): every pairwise alignment is re-emitted
padded to the merged profile. This module holds the profile extraction,
the merge, and the final row construction.

Conventions: aligned pairs are (a_row, b_row) int8 with gap_code for gaps
*and* padding; columns where both rows are gaps are dead padding and are
ignored (the k-mer assembly path produces interior dead columns by design).
Index math that the reference clamps is clamped here; its dropped scatters
(``mode="drop"``) go to one extra slot that is cropped away.
"""
from __future__ import annotations

import torch


def _cpos_and_masks(a_row, b_row, gap_code):
    """Per-column center index + insertion mask, (B, P) each."""
    ischar_b = b_row != gap_code
    ins = (b_row == gap_code) & (a_row != gap_code)   # real insertion
    cb = ischar_b.to(torch.int32)
    # number of center chars strictly before column t (exclusive cumsum)
    cpos = torch.cumsum(cb, dim=1, dtype=torch.int32) - cb
    return ischar_b, ins, cpos


def gap_profiles(a_rows, b_rows, *, gap_code: int, num_slots: int):
    """Insert-space profiles g[i, j] = #gaps pair i inserts before center
    char j, (N, num_slots) int32; num_slots >= lc + 1."""
    _, ins, cpos = _cpos_and_masks(a_rows, b_rows, gap_code)
    seg = cpos.clamp(0, num_slots - 1).long()
    g = torch.zeros((a_rows.shape[0], num_slots), dtype=torch.int32,
                    device=a_rows.device)
    return g.scatter_add_(1, seg, ins.to(torch.int32))


def merge_profiles(g):
    """reduce(1): merged center profile = columnwise max over pairs."""
    return torch.amax(g, dim=0)


def msa_width(G, lc: int) -> int:
    """Final MSA width (host-side)."""
    return int(lc) + int(torch.sum(G))


def build_rows(a_rows, b_rows, G, *, gap_code: int, out_len: int):
    """map(2): place each sequence's chars into the merged-profile frame.

    Layout: for center char j, columns [col(j)-G[j], col(j)) are its
    insertion block (right-packed) and col(j) = j + cumsum(G)[j] holds the
    char itself.
    """
    N, P = a_rows.shape
    dev = a_rows.device
    slots = G.shape[0]
    col_of = torch.arange(slots, device=dev) + torch.cumsum(G, 0)
    ischar_b, ins, cpos = _cpos_and_masks(a_rows, b_rows, gap_code)
    j = cpos.clamp(0, slots - 1).long()
    ins_i = ins.to(torch.int32)
    # rank of each insertion within its run (contiguity not required)
    cumins = torch.cumsum(ins_i, dim=1, dtype=torch.int32)
    g_here = torch.zeros((N, slots), dtype=torch.int32, device=dev)
    g_here.scatter_add_(1, j, ins_i)
    col = torch.arange(P, device=dev).expand(N, P)
    last_char_idx = torch.cummax(torch.where(ischar_b, col, -1), dim=1).values
    base = torch.where(last_char_idx >= 0,
                       cumins.gather(1, last_char_idx.clamp(min=0)), 0)
    o = cumins - 1 - base
    tgt_char = col_of[j]
    tgt_ins = tgt_char - g_here.gather(1, j) + o
    target = torch.where(ischar_b, tgt_char,
                         torch.where(ins, tgt_ins, out_len))
    target = torch.where(a_rows != gap_code, target, out_len)
    row = torch.full((N, out_len + 1), gap_code, dtype=torch.int8,
                     device=dev)
    row.scatter_(1, target.clamp(0, out_len).long(), a_rows)
    return row[:, :out_len]


def center_msa_row(center, lc, G, *, gap_code: int, out_len: int):
    """The center sequence's own row in the merged frame."""
    dev = center.device
    slots = G.shape[0]
    col_of = torch.arange(slots, device=dev) + torch.cumsum(G, 0)
    idx = torch.arange(center.shape[0], device=dev)
    target = torch.where(idx < int(lc), col_of[idx.clamp(0, slots - 1)],
                         out_len)
    row = torch.full((out_len + 1,), gap_code, dtype=torch.int8, device=dev)
    row.scatter_(0, target.long(), center)
    return row[:out_len]
