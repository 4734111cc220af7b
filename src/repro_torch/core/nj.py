"""Neighbor-Joining (Saitou & Nei 1987) — the paper's tree builder.

The distance matrix stays on its device as a fixed (S, S) tensor with an
active-slot mask; each of the ``size - 2`` merges is a vectorized O(S^2)
Q-matrix + argmin, updated in place on D (the caller's matrix is
overwritten). The merge indices stay on the device, so the loop never
waits for the host. ``nj_batch`` runs the same merges over a (B, S, S)
stack of padded matrices at once — HPTree's per-cluster NJ.

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


def _row_sums(X):
    """Sums over the last axis in one fixed order (halving folds over a
    zero-padded power-of-two width): only elementwise adds, so a row's
    sum has the same bits whatever batch it sits in."""
    S = X.shape[-1]
    width = 1 << (S - 1).bit_length() if S > 1 else 1
    if width != S:
        X = torch.nn.functional.pad(X, (0, width - S))
    while X.shape[-1] > 1:
        h = X.shape[-1] // 2
        X = X[..., :h] + X[..., h:]
    return X[..., 0]


def nj_batch(Ds, sizes) -> Tree:
    """NJ over a (B, S, S) stack of padded matrices, matrix b over its
    leading ``sizes[b]`` slots: one masked loop of S - 2 steps, in which
    matrix b merges while ``t < sizes[b] - 2`` (the reference vmaps
    ``neighbor_joining``). Sizes 1 and 2 make no merge, only the root
    join. ``root`` and ``n_leaves`` are (B,) tensors."""
    B, S, _ = Ds.shape
    dev = Ds.device
    D = Ds.to(torch.float32).clone()
    sizes = torch.as_tensor(np.asarray(sizes), dtype=torch.int64, device=dev)
    bi = torch.arange(B, device=dev)
    slots = torch.arange(S, device=dev)
    off_diag = ~torch.eye(S, dtype=torch.bool, device=dev)
    active = slots[None, :] < sizes[:, None]
    node_id = slots.to(torch.int32).repeat(B, 1)
    children = torch.full((B, 2 * S - 1, 2), -1, dtype=torch.int32,
                          device=dev)
    blen = torch.zeros((B, 2 * S - 1, 2), dtype=torch.float32, device=dev)

    for t in range(S - 2):
        do = t < sizes - 2                                   # (B,)
        actf = active.to(torch.float32)
        pair = actf[:, :, None] * actf[:, None, :]
        na = torch.sum(actf, dim=1)                          # exact
        R = _row_sums(D * pair)
        Q = (na - 2.0)[:, None, None] * D - R[:, :, None] - R[:, None, :]
        Qm = torch.where((pair > 0) & off_diag, Q, INF)
        idx = torch.argmin(Qm.reshape(B, -1), dim=1)         # first on ties
        i, j = idx // S, idx % S
        dij = D[bi, i, j]
        denom = 2.0 * torch.clamp(na - 2.0, min=1.0)
        li = 0.5 * dij + (R[bi, i] - R[bi, j]) / denom
        lj = dij - li
        new_id = sizes + t
        # a matrix that is done keeps its state: every write below puts
        # back the old value where ``do`` is False
        keep = do[:, None]
        drow = 0.5 * (D[bi, i] + D[bi, j] - dij[:, None])    # (B, S)
        old_ii = D[bi, i, i]
        D[bi, i] = torch.where(keep, drow, D[bi, i])
        D[bi, :, i] = torch.where(keep, drow, D[bi, :, i])
        D[bi, i, i] = torch.where(do, torch.zeros_like(old_ii), old_ii)
        children[bi, new_id] = torch.where(
            keep, torch.stack([node_id[bi, i], node_id[bi, j]], dim=1),
            children[bi, new_id])
        blen[bi, new_id] = torch.where(keep, torch.stack([li, lj], dim=1),
                                       blen[bi, new_id])
        node_id[bi, i] = torch.where(do, new_id.to(torch.int32),
                                     node_id[bi, i])
        active[bi, j] = active[bi, j] & ~do

    # join the two surviving nodes of each matrix at its root
    order = torch.argsort(torch.where(active, slots, S), dim=1, stable=True)
    a, b = order[:, 0], order[:, 1]
    root = 2 * sizes - 2
    half = D[bi, a, b] / 2.0
    children[bi, root] = torch.stack([node_id[bi, a], node_id[bi, b]], dim=1)
    blen[bi, root] = torch.stack([half, half], dim=1)
    return Tree(children, blen, root, sizes)


def host_tree(tree: Tree):
    """``Tree`` -> ``(children, blen, root)`` numpy triple."""
    return tree.children.cpu().numpy(), tree.blen.cpu().numpy(), int(tree.root)
