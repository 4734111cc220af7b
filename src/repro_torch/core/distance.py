"""Pairwise distance matrices from MSA results.

The N x N p-distance over aligned columns is the compute hot-spot of the
phylogeny stage. The match/valid counts go through
``repro_torch.kernels.distance.ops.match_valid`` — the hand-written
kernel on a CUDA tensor, its plain one-hot version on a CPU tensor.
Counts are exact integers, returned as float32 like the reference's.
"""
from __future__ import annotations

import torch


def match_valid_counts(msa, other=None, *, gap_code: int, n_chars: int):
    """Returns (match, valid) float32: per-pair counts of equal non-gap
    columns and both-non-gap columns. With ``other`` given, the (N, M)
    cross counts instead."""
    from ..kernels.distance.ops import match_valid
    other = msa if other is None else other
    match, valid = match_valid(msa.contiguous(), other.contiguous(),
                               n_chars=n_chars, gap_code=gap_code)
    return match.to(torch.float32), valid.to(torch.float32)


def jc69_distance(p):
    """Jukes-Cantor correction d = -3/4 ln(1 - 4/3 p), clipped to stay finite."""
    x = torch.clamp(1.0 - 4.0 / 3.0 * p, 1e-6, 1.0)
    return -0.75 * torch.log(x)


def counts_to_distance(match, valid, *, correct: bool = True):
    """JC69 (or raw p) distances from (match, valid) count blocks."""
    p = 1.0 - match / torch.clamp(valid, min=1.0)
    p = torch.where(valid > 0, p, torch.full_like(p, 0.75))  # no overlap
    return jc69_distance(p) if correct else p


def distance_matrix(msa, *, gap_code: int, n_chars: int, correct: bool = True):
    match, valid = match_valid_counts(msa, gap_code=gap_code, n_chars=n_chars)
    d = counts_to_distance(match, valid, correct=correct)
    d = (d + d.T) / 2.0
    return d * (1.0 - torch.eye(d.shape[0], device=d.device))
