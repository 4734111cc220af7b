"""Plain PyTorch version of the match/valid kernel (``csrc/match_valid.cu``).

Chunked one-hot products, as the reference's ``core.distance`` computes
them: per chunk of columns, ``valid += na @ nb.T`` and
``match += onehot(a) @ onehot(b).T`` in float32 (exact for counts below
2^24), returned as int32. The group form gathers each group's rows and
runs the same products batched.
"""
from __future__ import annotations

import torch


def match_valid_ref(msa_a, msa_b, *, n_chars: int, gap_code: int,
                    chunk: int = 512):
    """msa_a (N, L) int8, msa_b (M, L) int8 -> (match, valid) (N, M) int32."""
    N, L = msa_a.shape
    M = msa_b.shape[0]
    dev = msa_a.device
    match = torch.zeros((N, M), dtype=torch.float32, device=dev)
    valid = torch.zeros((N, M), dtype=torch.float32, device=dev)
    sym = torch.arange(n_chars, device=dev)

    def onehot(blk):
        oh = (blk[:, :, None] == sym) & (blk[:, :, None] != gap_code)
        return oh.to(torch.float32).reshape(blk.shape[0], -1)

    for c0 in range(0, L, chunk):
        ba = msa_a[:, c0:c0 + chunk].long()
        bb = msa_b[:, c0:c0 + chunk].long()
        na = ((ba != gap_code) & (ba < n_chars)).to(torch.float32)
        nb = ((bb != gap_code) & (bb < n_chars)).to(torch.float32)
        valid += na @ nb.T
        match += onehot(ba) @ onehot(bb).T
    return match.to(torch.int32), valid.to(torch.int32)


def match_valid_groups_ref(msa, index, *, n_chars: int, gap_code: int,
                           chunk: int = 512):
    """msa (R, L) int8, index (G, S) int64 row ids (-1: a pad row) ->
    (match, valid) (G, S, S) int32 over the rows ``msa[index[g]]``: a
    gather, then the same products batched, a pad row's planes zero."""
    G, S = index.shape
    L = msa.shape[1]
    dev = msa.device
    live = (index >= 0)[:, :, None]                            # (G, S, 1)
    rows = msa[index.clamp(min=0)]                             # (G, S, L)
    match = torch.zeros((G, S, S), dtype=torch.float32, device=dev)
    valid = torch.zeros((G, S, S), dtype=torch.float32, device=dev)
    sym = torch.arange(n_chars, device=dev)
    for c0 in range(0, L, chunk):
        blk = rows[:, :, c0:c0 + chunk].long()
        v = ((blk != gap_code) & (blk < n_chars) & live).to(torch.float32)
        oh = ((blk[..., None] == sym) & (blk[..., None] != gap_code)
              & live[..., None]).to(torch.float32).flatten(2)
        valid += v @ v.transpose(1, 2)
        match += oh @ oh.transpose(1, 2)
    return match.to(torch.int32), valid.to(torch.int32)
