"""Sum-of-pairs scoring — the paper's MSA quality metric.

Comparing two rows column by column costs 1 when two residues differ, 2
when a residue faces an inserted space, 0 otherwise; SP is the sum over
all row pairs, avg SP is SP / #pairs. Lower is better (it is a penalty).
The mismatch counts come from the match/valid kernel; the half-gap counts
are one float64 product, which no TF32 setting touches, so they stay exact.
"""
from __future__ import annotations

import torch

from .distance import match_valid_counts


def sp_pair_matrix(msa, *, gap_code: int, n_chars: int):
    """(N, N) matrix of pairwise column costs (mismatch=1, half-gap=2)."""
    match, valid = match_valid_counts(msa, gap_code=gap_code, n_chars=n_chars)
    mismatch = valid - match
    nongap = (msa != gap_code).to(torch.float64)
    hg = (1.0 - nongap) @ nongap.T
    half_gap = (hg + hg.T).to(torch.float32)
    return mismatch + 2.0 * half_gap


def sp_score(msa, *, gap_code: int, n_chars: int):
    """Total SP penalty over all unordered row pairs."""
    M = sp_pair_matrix(msa, gap_code=gap_code, n_chars=n_chars)
    return (torch.sum(M) - torch.sum(torch.diag(M))) / 2.0


def avg_sp(msa, *, gap_code: int, n_chars: int):
    n = msa.shape[0]
    pairs = n * (n - 1) / 2.0
    return sp_score(msa, gap_code=gap_code, n_chars=n_chars) / pairs
