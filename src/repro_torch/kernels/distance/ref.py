"""Plain PyTorch version of the match/valid kernel (``csrc/match_valid.cu``).

Chunked one-hot products, as the reference's ``core.distance`` computes
them: per chunk of columns, ``valid += na @ nb.T`` and
``match += onehot(a) @ onehot(b).T`` in float32 (exact for counts below
2^24), returned as int32.
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
