"""Plain reference for the distance stage, neighbor joining and SP score.

Nothing here imports the program. ``dtype`` is the precision the
distances and the joins are carried in: float64 for the reference,
a lower one for the control run in the program's place.

* ``pair_counts``: per pair of rows, the columns where both hold a
  residue (``valid``) and where they hold the same one (``match``), as
  float32 one-hot products with TF32 off: exact integers below 2^24.
* ``jc69``: d = -3/4 ln(1 - 4/3 p), p = 1 - match / valid (0.75 where no
  column is shared), the log's argument clipped to [1e-6, 1].
* ``nj_replay``: follows the joins of a given tree on the reference's
  distances and reads, at every join, how far the tree's pair lies from
  the least Q, and the branch lengths it should have.
* ``nj``: neighbor joining that picks each join itself (the control).
* ``sp_total``: the sum-of-pairs penalty from per-column counts.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

# the control's precision: the configuration states float32
LOWER = {"bf16": torch.bfloat16}


@contextlib.contextmanager
def exact_float32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pair_counts(rows: torch.Tensor, n_chars: int, gap_code: int,
                dtype=torch.float32, block: int = 1024):
    """(match, valid) (N, N) in ``dtype`` (float32: exact counts)."""
    N, L = rows.shape
    dev = rows.device
    match = torch.zeros((N, N), dtype=dtype, device=dev)
    valid = torch.zeros((N, N), dtype=dtype, device=dev)
    sym = torch.arange(n_chars, device=dev)
    with exact_float32():
        for c0 in range(0, L, block):
            blk = rows[:, c0:c0 + block].long()
            res = (blk != gap_code) & (blk < n_chars)
            oh = ((blk[:, :, None] == sym) & res[:, :, None]).to(dtype)
            oh = oh.reshape(N, -1)
            r = res.to(dtype)
            valid += r @ r.T
            match += oh @ oh.T
    return match, valid


def jc69(match, valid, dtype=torch.float64):
    match, valid = match.to(dtype), valid.to(dtype)
    p = 1.0 - match / torch.clamp(valid, min=1.0)
    p = torch.where(valid > 0, p, torch.full_like(p, 0.75))
    x = torch.clamp(1.0 - 4.0 / 3.0 * p, 1e-6, 1.0)
    d = -0.75 * torch.log(x)
    d = 0.5 * (d + d.T)
    return d * (1.0 - torch.eye(d.shape[0], dtype=dtype, device=d.device))


def distances(rows: torch.Tensor, *, n_chars: int, gap_code: int,
              dtype=torch.float64):
    count_dtype = torch.float32 if dtype == torch.float64 else dtype
    m, v = pair_counts(rows, n_chars, gap_code, count_dtype)
    return jc69(m, v, dtype)


def _blocked(n: int, dtype, device):
    """(blocked, active): +inf on the diagonal and 0 elsewhere, which,
    added to Q, leaves out the diagonal and, once their rows and columns
    are set to +inf, the slots already joined; and 1 for every slot."""
    return (torch.diag(torch.full((n,), float("inf"), dtype=dtype,
                                  device=device)),
            torch.ones(n, dtype=dtype, device=device))


def _merge(D, state, na: int, i: int, j: int):
    """One join of slots i and j over ``na`` active slots, on D in place
    (rows and columns of joined slots are 0 in D and +inf in the blocked
    mask of ``state``); returns (Q of the pair, least Q, l_i, l_j) as
    0-d tensors."""
    blocked, active = state
    R = D.sum(dim=1)
    Q = (na - 2.0) * D - R[:, None] - R[None, :]
    qmin = (Q + blocked).amin()
    dij = D[i, j]
    li = 0.5 * dij + (R[i] - R[j]) / (2.0 * max(na - 2.0, 1.0))
    lj = dij - li
    active[j] = 0.0
    row = 0.5 * (D[i] + D[j] - dij) * active
    D[i] = row
    D[:, i] = row
    D[i, i] = 0.0
    D[j] = 0.0
    D[:, j] = 0.0
    blocked[j] = float("inf")
    blocked[:, j] = float("inf")
    return Q[i, j], qmin, li, lj


def nj_replay(D, children: np.ndarray, blen: np.ndarray, root: int, *,
              floor: bool = False):
    """Joins of the tree (``children``/``blen`` of 2n - 1 nodes, leaves
    0..n-1, internal nodes in join order, ``root`` the last) replayed on
    the reference's (n, n) distances ``D`` (overwritten).

    Returns ``(q_gap, blen_err, topology_bad)``: the largest
    (Q(pair) - least Q) / |least Q| over the joins, the largest
    |branch length - the reference's| over the mean |reference length|,
    and 1 when the tree is not a join sequence over all leaves. With
    ``floor`` the given lengths are held against the reference's floored
    at 0."""
    n = D.shape[0]
    children = np.asarray(children, np.int64)
    blen = np.asarray(blen, np.float64)
    if children.shape != (2 * n - 1, 2) or int(root) != 2 * n - 2:
        return float("inf"), float("inf"), 1
    slot = np.full(2 * n - 1, -1, np.int64)
    slot[:n] = np.arange(n)
    pairs = []
    for t in range(n - 2):
        a, b = (int(x) for x in children[n + t])
        if not (0 <= a < n + t and 0 <= b < n + t) or a == b \
                or slot[a] < 0 or slot[b] < 0:
            return float("inf"), float("inf"), 1
        pairs.append((int(slot[a]), int(slot[b])))
        slot[n + t] = slot[a]
        slot[a] = slot[b] = -1
    live = sorted(int(x) for x in np.flatnonzero(slot[:2 * n - 2] >= 0))
    if sorted(int(x) for x in children[root]) != live:
        return float("inf"), float("inf"), 1
    state = _blocked(n, D.dtype, D.device)
    gaps = torch.zeros(max(n - 2, 1), dtype=D.dtype, device=D.device)
    lens = torch.zeros((2 * n - 1, 2), dtype=D.dtype, device=D.device)
    for t, (i, j) in enumerate(pairs):
        q, qmin, li, lj = _merge(D, state, n - t, i, j)
        gaps[t] = (q - qmin) / torch.clamp(qmin.abs(), min=1e-300)
        lens[n + t, 0] = li
        lens[n + t, 1] = lj
    a, b = (int(slot[int(c)]) for c in children[root])
    lens[root] = D[a, b] / 2.0
    ref = lens.cpu().numpy()[n:]
    if floor:
        ref = np.maximum(ref, 0.0)
    scale = max(float(np.abs(ref).mean()), 1e-12)
    q_gap = float(gaps.max().cpu()) if n > 2 else 0.0
    return q_gap, float(np.abs(blen[n:] - ref).max()) / scale, 0


def nj(D):
    """Neighbor joining picking each join itself: the least Q, the first
    in row-major order on ties. Returns (children, blen, root) as host
    arrays in the layout ``nj_replay`` reads."""
    n = D.shape[0]
    state = _blocked(n, D.dtype, D.device)
    node = np.arange(n)
    alive = np.ones(n, bool)
    children = np.full((2 * n - 1, 2), -1, np.int64)
    blen = np.zeros((2 * n - 1, 2), np.float64)
    for t in range(n - 2):
        na = n - t
        R = D.sum(dim=1)
        Q = (na - 2.0) * D - R[:, None] - R[None, :]
        i, j = divmod(int((Q + state[0]).reshape(-1).argmin()), n)
        _, _, li, lj = _merge(D, state, na, i, j)
        children[n + t] = node[i], node[j]
        blen[n + t] = float(li), float(lj)
        node[i] = n + t
        alive[j] = False
    a, b = (int(x) for x in np.flatnonzero(alive)[:2])
    root = 2 * n - 2
    children[root] = node[a], node[b]
    blen[root] = float(D[a, b]) / 2.0
    return children, blen, root


def sp_total(msa: np.ndarray, n_chars: int, gap_code: int) -> int:
    """Sum over unordered row pairs and columns of 1 for two different
    residues and 2 for a residue facing a gap, from per-column counts:
    (r^2 - sum_c n_c^2) / 2 + 2 g r with r residues and g gaps."""
    msa = np.asarray(msa)
    total = 0
    for c0 in range(0, msa.shape[1], 512):
        blk = msa[:, c0:c0 + 512]
        counts = np.stack([(blk == c).sum(axis=0) for c in range(n_chars)]
                          ).astype(np.int64)
        r = counts.sum(axis=0)
        g = (blk == gap_code).sum(axis=0).astype(np.int64)
        total += int(((r * r - (counts * counts).sum(axis=0)) // 2
                      + 2 * g * r).sum())
    return total


def sp_lower(msa: torch.Tensor, n_chars: int, gap_code: int, dtype):
    """The average SP penalty computed in ``dtype`` through pair counts
    (the control's path)."""
    m, v = pair_counts(msa, n_chars, gap_code, dtype)
    res = (msa != gap_code).to(dtype)
    hg = (1.0 - res) @ res.T
    M = (v - m) + 2.0 * (hg + hg.T)
    n = msa.shape[0]
    return float((M.sum() - torch.diagonal(M).sum()) / 2.0
                 / (n * (n - 1) / 2.0))
