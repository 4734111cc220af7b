"""Neighbor-Joining (Saitou & Nei 1987) — the paper's tree builder.

The distance matrix stays on its device as a fixed (S, S) tensor with an
active-slot mask; each of the ``size - 2`` merges is a vectorized O(S^2)
Q-matrix + argmin, updated in place on D (the caller's matrix is
overwritten). The merge indices stay on the device, so the loop never
waits for the host.

Tree representation (shared with treeio):
  nodes 0..size-1 are leaves; size..2*size-2 are internal, created in merge
  order (children always have smaller ids). children: (2S-1, 2) i32 (-1 for
  leaf), blen: (2S-1, 2) f32 edge lengths to each child.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INF = 1e30


class Tree(NamedTuple):
    children: torch.Tensor   # (2S-1, 2) i32
    blen: torch.Tensor       # (2S-1, 2) f32
    root: int                # 2*size-2
    n_leaves: int


def neighbor_joining(D, size: int) -> Tree:
    """NJ over the leading ``size`` slots of the (S, S) distance matrix."""
    S = D.shape[0]
    dev = D.device
    D = D.to(torch.float32)
    eye = torch.eye(S, dtype=torch.bool, device=dev)
    active = torch.arange(S, device=dev) < size
    node_id = torch.arange(S, dtype=torch.int32, device=dev)
    children = torch.full((2 * S - 1, 2), -1, dtype=torch.int32, device=dev)
    blen = torch.zeros((2 * S - 1, 2), dtype=torch.float32, device=dev)

    for t in range(max(size - 2, 0)):
        actf = active.to(torch.float32)
        pair = actf[:, None] * actf[None, :]
        na = torch.sum(actf)
        R = torch.sum(D * pair, dim=1)
        Q = (na - 2.0) * D - R[:, None] - R[None, :]
        Qm = torch.where((pair > 0) & ~eye, Q, INF)
        idx = torch.argmin(Qm.reshape(-1))[None]   # 1-d: no host sync
        i, j = idx // S, idx % S
        dij = D[i, j]
        denom = 2.0 * torch.clamp(na - 2.0, min=1.0)
        li = 0.5 * dij + (R[i] - R[j]) / denom
        lj = dij - li
        new_id = size + t
        drow = 0.5 * (D[i, :] + D[j, :] - dij[:, None])       # (1, S)
        D.index_copy_(0, i, drow)
        D.index_copy_(1, i, drow.T)
        D[i, i] = 0.0
        children[new_id] = torch.cat([node_id[i], node_id[j]])
        blen[new_id] = torch.cat([li, lj])
        node_id[i] = new_id
        active[j] = False

    # join the two surviving nodes at the root
    order = torch.argsort(torch.where(active, torch.arange(S, device=dev), S),
                          stable=True)
    a, b = order[:1], order[1:2]
    root = 2 * size - 2
    half = D[a, b] / 2.0
    children[root] = torch.cat([node_id[a], node_id[b]])
    blen[root] = torch.cat([half, half])
    return Tree(children, blen, root, size)


def host_tree(tree: Tree):
    """``Tree`` -> ``(children, blen, root)`` numpy triple."""
    return tree.children.cpu().numpy(), tree.blen.cpu().numpy(), int(tree.root)
