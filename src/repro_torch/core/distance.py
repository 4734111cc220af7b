"""Pairwise distance matrices from MSA results.

The N x N p-distance over aligned columns is the compute hot-spot of the
phylogeny stage. The match/valid counts go through
``repro_torch.kernels.distance.ops.match_valid`` — the hand-written
kernel on a CUDA tensor, its plain one-hot version on a CPU tensor.
Counts are exact integers, returned as float32 like the reference's.
``distance_groups`` computes many small matrices (the HPTree clusters)
in one kernel launch, each entry the float ``distance_matrix`` gives.
"""
from __future__ import annotations

import numpy as np
import torch


def match_valid_counts(msa, other=None, *, gap_code: int, n_chars: int):
    """Returns (match, valid) float32: per-pair counts of equal non-gap
    columns and both-non-gap columns. With ``other`` given, the (N, M)
    cross counts instead."""
    from ..kernels.distance.ops import match_valid
    match, valid = match_valid(
        msa.contiguous(), None if other is None else other.contiguous(),
        n_chars=n_chars, gap_code=gap_code)
    return match.to(torch.float32), valid.to(torch.float32)


def p_distance(msa, *, gap_code: int, n_chars: int):
    match, valid = match_valid_counts(msa, gap_code=gap_code, n_chars=n_chars)
    p = 1.0 - match / torch.clamp(valid, min=1.0)
    return torch.where(valid > 0, p, torch.full_like(p, 0.75))  # no overlap


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


def cross_distance(msa, other, *, gap_code: int, n_chars: int,
                   correct: bool = True):
    """(N, M) distances between two row sets (medoid assignment, tiles)."""
    match, valid = match_valid_counts(msa, other, gap_code=gap_code,
                                      n_chars=n_chars)
    return counts_to_distance(match, valid, correct=correct)


def group_index(groups, width: int, device) -> torch.Tensor:
    """(G, width) int64 row ids of ``distance_groups``: group g's rows,
    then -1 (a pad row) up to ``width``."""
    index = np.full((len(groups), width), -1, np.int64)
    for g, rows in enumerate(groups):
        index[g, :len(rows)] = rows
    return torch.from_numpy(index).to(device)


def distance_groups(msa, index, *, gap_code: int, n_chars: int,
                    correct: bool = True):
    """(G, S, S) float32 distance matrices of the row groups ``index``
    ((G, S) ids into ``msa``, -1 a pad row), counted in one launch: each
    real entry is the float ``distance_matrix(msa[rows of g])`` gives (the
    same elementwise ops, batched); pad entries are 0, as in the padded
    matrices ``nj_batch`` takes."""
    from ..kernels.distance.ops import match_valid_groups
    match, valid = match_valid_groups(msa.contiguous(), index,
                                      n_chars=n_chars, gap_code=gap_code)
    d = counts_to_distance(match.to(torch.float32), valid.to(torch.float32),
                           correct=correct)
    d = (d + d.transpose(1, 2)) / 2.0
    d = d * (1.0 - torch.eye(d.shape[1], device=d.device))
    live = index >= 0
    return torch.where(live[:, :, None] & live[:, None, :], d,
                       torch.zeros((), device=d.device))
