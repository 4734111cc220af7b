"""Progressive MSA baseline (MUSCLE/ClustalW family) — the paper's Table 2-4
comparison class, so the port has its own in-repo baseline:

  1. guide tree: k-mer composition sketches -> cosine distances -> UPGMA
     (MUSCLE's draft-tree stage);
  2. progressive alignment up the tree: profile-profile Needleman-Wunsch
     (linear gaps), column score = f_a^T S f_b — one (La, Lb) matrix
     product per merge, then a row loop on the device and a host
     traceback.

Quality beats center-star on diverged families (every merge is optimal
w.r.t. profiles) at O(N) DP passes over growing profiles — the classic
accuracy/scalability trade the paper's tables show.

The reference runs its DP as a ``lax.scan``, not a Pallas kernel, so the
port's DP is plain PyTorch: the rows' values in the reference's order of
float32 operations (the column scores as ``(pa @ sub) @ pb.T``), so that
the ties ``h == diag`` and ``h == up`` split as the reference splits them.
The matrix products themselves sum in another order than XLA's, so on
profiles of mixed columns a column score can differ in its last bit and
a near-tie can split the other way (``tests/test_torch_progressive.py``
shows it); one-hot profiles are exact.
``progressive_msa`` runs on ``device``: the card by default, raising
without one; ``device="cpu"`` runs the same code on the CPU.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import alphabet as ab
from ..device import resolve_device
from .msa import MSAConfig, MSAResult

NEG = -1.0e7


def kmer_sketch(S, lens, *, n_chars: int, k: int = 4):
    """(N, n_chars^k) L2-normalized k-mer composition vectors of the
    encoded rows ``S`` (N, L) with lengths ``lens`` (N,), on their device:
    one scatter-add histogram."""
    N, L = S.shape
    dev = S.device
    n_codes = n_chars ** k
    powers = torch.tensor([n_chars ** i for i in range(k)], dtype=torch.int64,
                          device=dev)
    windows = torch.stack([S[:, i: L - k + 1 + i] for i in range(k)],
                          dim=-1).to(torch.int64)
    codes = (windows * powers).sum(-1)
    pos = torch.arange(max(L - k + 1, 0), device=dev)
    valid = (windows < n_chars).all(-1) & \
        (pos[None, :] < (lens.to(torch.int64) - k + 1)[:, None])
    codes = torch.where(valid, codes, torch.full_like(codes, n_codes))
    H = torch.zeros((N, n_codes + 1), dtype=torch.float32, device=dev)
    H.scatter_add_(1, codes, torch.ones(codes.shape, dtype=torch.float32,
                                        device=dev))
    H = H[:, :n_codes]
    return H / torch.clamp(torch.linalg.norm(H, dim=1, keepdim=True),
                           min=1e-9)


def upgma(D: np.ndarray):
    """Host UPGMA; returns merge list [(a, b, new_id)] with leaf ids 0..N-1."""
    N = D.shape[0]
    D = D.copy().astype(np.float64)
    np.fill_diagonal(D, np.inf)
    active = {i: 1 for i in range(N)}   # id -> cluster size
    idx = {i: i for i in range(N)}      # id -> row in D
    merges = []
    nxt = N
    for _ in range(N - 1):
        ids = list(active)
        sub = np.array([[D[idx[a], idx[b]] if a != b else np.inf
                         for b in ids] for a in ids])
        i, j = np.unravel_index(np.argmin(sub), sub.shape)
        a, b = ids[i], ids[j]
        sa, sb = active[a], active[b]
        ra, rb = idx[a], idx[b]
        newrow = (D[ra] * sa + D[rb] * sb) / (sa + sb)
        D[ra] = newrow
        D[:, ra] = newrow
        D[ra, ra] = np.inf
        merges.append((a, b, nxt))
        del active[a], active[b]
        active[nxt] = sa + sb
        idx[nxt] = ra
        nxt += 1
    return merges


def profile_align_dirs(pa, pb, sub, *, gap_pen: float):
    """Linear-gap NW over profiles pa (La, C), pb (Lb, C) float32; returns
    (dirs (La+1, Lb+1) int8: 0 diagonal, 1 up, 2 left; the score)."""
    S = (pa @ sub) @ pb.T                              # (La, Lb) column scores
    H = nw_rows(S, gap_pen)
    return nw_dirs(H, S, gap_pen), H[-1, -1]


def nw_rows(S, gap_pen: float):
    """Every row of the DP over column scores S (La, Lb): H (La+1, Lb+1).

    Row i: H[i,j] = max(H[i-1,j-1] + S, H[i-1,j] - g, max_k<j H[i,k] -
    (j-k) g), the left term a running max (``torch.cummax``), each value
    from the reference's float32 operations in its order.
    """
    La, Lb = S.shape
    dev = S.device
    g = float(gap_pen)
    jj = torch.arange(Lb + 1, dtype=torch.float32, device=dev)
    jjg = jj * g
    tail = (jj[1:] - 1.0) * g
    H = torch.empty((La + 1, Lb + 1), dtype=torch.float32, device=dev)
    H[0] = -g * jj
    up = torch.empty(Lb + 1, dtype=torch.float32, device=dev)
    diag = torch.full((Lb + 1,), NEG, dtype=torch.float32, device=dev)
    m = torch.empty_like(up)
    run = torch.empty_like(up)
    left = torch.full((Lb + 1,), NEG, dtype=torch.float32, device=dev)
    for i in range(La):
        h = H[i]
        torch.sub(h, g, out=up)
        torch.add(h[:-1], S[i], out=diag[1:])
        torch.maximum(up, diag, out=m)
        torch.add(m, jjg, out=run)
        cm = torch.cummax(run, 0).values
        torch.sub(cm[:-1], g, out=left[1:])
        left[1:] -= tail
        torch.maximum(m, left, out=H[i + 1])
    return H


def nw_dirs(H, S, gap_pen: float):
    """The directions of ``nw_rows``' rows in one pass: 0 where a cell
    equals its diagonal candidate, else 1 where it equals its up
    candidate, else 2 (the candidates as the rows computed them)."""
    La = S.shape[0]
    g = float(gap_pen)
    Hp, Hn = H[:-1], H[1:]
    diag = torch.cat([torch.full((La, 1), NEG, dtype=torch.float32,
                                 device=H.device), Hp[:, :-1] + S], dim=1)
    dirs = torch.empty(H.shape, dtype=torch.int8, device=H.device)
    dirs[0] = 2
    dirs[0, 0] = 0
    dirs[1:] = torch.where(Hn == diag, 0, torch.where(Hn == Hp - g, 1, 2)).to(
        torch.int8)
    return dirs


def _traceback_host(dirs: np.ndarray, La: int, Lb: int):
    i, j = La, Lb
    cols_a, cols_b = [], []
    while i > 0 or j > 0:
        d = dirs[i, j]
        if i > 0 and j > 0 and d == 0:
            i -= 1
            j -= 1
            cols_a.append(i)
            cols_b.append(j)
        elif i > 0 and (d == 1 or j == 0):
            i -= 1
            cols_a.append(i)
            cols_b.append(-1)
        else:
            j -= 1
            cols_a.append(-1)
            cols_b.append(j)
    return cols_a[::-1], cols_b[::-1]


def _expand(rows: np.ndarray, cols: List[int], gap: int) -> np.ndarray:
    out = np.full((rows.shape[0], len(cols)), gap, rows.dtype)
    for t, c in enumerate(cols):
        if c >= 0:
            out[:, t] = rows[:, c]
    return out


def progressive_msa(seqs, cfg: MSAConfig, *, device="cuda") -> MSAResult:
    """Progressive MSA of the strings ``seqs`` on ``device``: the sketches,
    the column scores and the DP rows there, the guide tree and the
    tracebacks on the host."""
    dev = resolve_device(device)
    alpha = cfg.alpha()
    gap = alpha.gap_code
    S, lens = ab.encode_batch(seqs, alpha)
    N = len(seqs)
    if N < 2:
        return MSAResult(np.asarray(S), 0, 0, S.shape[1])
    sub = cfg.matrix(dev)[: alpha.n_chars, : alpha.n_chars]

    sk = kmer_sketch(torch.as_tensor(S, device=dev),
                     torch.as_tensor(lens, device=dev), n_chars=alpha.n_chars,
                     k=3 if alpha.n_chars > 5 else 4)
    Dm = (1.0 - sk @ sk.T).cpu().numpy()
    merges = upgma(Dm)

    # cluster id -> (rows array (n, L), member leaf ids)
    groups = {i: (S[i: i + 1, : int(lens[i])], [i]) for i in range(N)}
    gap_pen = float(cfg.gap_open)

    def profile(rows):
        oh = (rows[:, :, None] == np.arange(alpha.n_chars)).astype(np.float32)
        return torch.as_tensor(oh.mean(axis=0), device=dev)

    for a, b, new in merges:
        ra, ma = groups.pop(a)
        rb, mb = groups.pop(b)
        pa, pb = profile(ra), profile(rb)
        dirs, _ = profile_align_dirs(pa, pb, sub, gap_pen=gap_pen)
        ca, cb = _traceback_host(dirs.cpu().numpy(), pa.shape[0],
                                 pb.shape[0])
        rows = np.concatenate([_expand(ra, ca, gap), _expand(rb, cb, gap)])
        groups[new] = (rows, ma + mb)

    rows, members = groups.popitem()[1]
    msa = np.empty_like(rows)
    msa[np.asarray(members)] = rows
    return MSAResult(msa, 0, 0, rows.shape[1])
