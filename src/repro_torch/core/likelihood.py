"""Log-likelihood of an MSA given a tree (Felsenstein pruning).

The paper evaluates phylogeny quality by maximum-likelihood value. Only the
JC69 closed-form evaluator over raw MSA columns is ported (what
``--tree-ll`` reports): partial likelihoods for all sites at once, a loop
over internal nodes in id order (children always have smaller ids than
their parent, in NJ and stitched trees alike), with per-node rescaling
against underflow. It runs on the rows' device and waits for it once, when
the caller reads the result. Site-pattern compression and the
general-model evaluator are not ported yet (ROADMAP.md §1 item 9).
"""
from __future__ import annotations

import numpy as np
import torch


def jc69_transition(t):
    """4x4 JC69 transition matrix for branch length t (expected subs/site).

    Exact at t == 0: ``exp(0) == 1`` makes the off-diagonal exactly zero
    and the diagonal exactly one.
    """
    t = torch.as_tensor(t, dtype=torch.float32)
    e = torch.exp(-4.0 * torch.clamp(t, min=0.0) / 3.0)
    same = 0.25 + 0.75 * e
    diff = 0.25 - 0.25 * e
    return diff[..., None, None] * torch.ones((4, 4), device=t.device) + \
        (same - diff)[..., None, None] * torch.eye(4, device=t.device)


def log_likelihood(msa, children, blen, root, *, gap_code: int):
    """JC69 logL (a 0-d float32 tensor); gap/N columns contribute
    uninformative all-ones partials.

    msa: (N, L) int8 tensor with codes A,C,G,T = 0..3; children (M, 2) and
    blen (M, 2) host arrays or tensors; ``gap_code`` is accepted for the
    reference's signature (every code >= 4 is uninformative).
    """
    N, L = msa.shape
    dev = msa.device
    children = (children.cpu().numpy() if isinstance(children, torch.Tensor)
                else np.asarray(children))
    M = children.shape[0]
    blen = (blen if isinstance(blen, torch.Tensor)
            else torch.from_numpy(np.array(blen, np.float32)))
    P = jc69_transition(blen.to(dev, torch.float32))
    Pt = P.transpose(-1, -2)                              # (M, 2, 4, 4)
    codes = msa.to(torch.int64)
    leaf_part = ((codes[..., None] == torch.arange(4, device=dev))
                 | (codes[..., None] >= 4)).to(torch.float32)  # (N, L, 4)
    parts = torch.zeros((M, L, 4), dtype=torch.float32, device=dev)
    parts[:N] = leaf_part
    scales = torch.zeros((M, L), dtype=torch.float32, device=dev)
    for node in range(N, M):
        c0, c1 = int(children[node, 0]), int(children[node, 1])
        if c0 < 0:
            continue
        part = (parts[c0] @ Pt[node, 0]) * (parts[c1] @ Pt[node, 1])
        m = torch.clamp(part.amax(dim=-1, keepdim=True), min=1e-30)
        parts[node] = part / m
        scales[node] = scales[c0] + scales[c1] + torch.log(m[..., 0])
    site_l = torch.sum(0.25 * parts[int(root)], dim=-1)
    return torch.sum(torch.log(torch.clamp(site_l, min=1e-30))
                     + scales[int(root)])
