"""Plain reference for the center-star alignment's rows.

Nothing here imports the program. The rows the program returns are
judged by what they determine:

* every row, its gaps removed, is its input sequence, and no column is
  all gaps;
* the pairwise alignment of a row with the center row (columns where
  both are gaps dropped) scores, under the configuration's affine
  scoring, what the configuration's pairwise method gives that pair: the
  global Gotoh optimum where the k-mer chain fails, else the chain's
  anchors plus the optimum of every segment between them.

The Gotoh recurrences run over anti-diagonals, batched over pairs, in
integer arithmetic; the k-mer chain is a per-pair numpy loop.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

NEG = -(10 ** 9)
_CODES = np.full(256, 4, np.int8)           # anything else is N
for _i, _c in enumerate("ACGT"):
    _CODES[ord(_c)] = _CODES[ord(_c.lower())] = _i
_CODES[ord("U")] = _CODES[ord("u")] = 3


def encode(seq: str) -> np.ndarray:
    """A, C, G, T (U) -> 0..3, anything else -> 4 (N)."""
    return _CODES[np.frombuffer(seq.encode("ascii"), np.uint8)]


def sub_matrix(scoring: dict, gap_code: int) -> np.ndarray:
    """(gap_code + 1)^2 substitution scores: match on the diagonal,
    mismatch elsewhere, 0 against N (code 4) or a gap."""
    n = gap_code + 1
    m = np.full((n, n), int(scoring["mismatch"]), np.int64)
    np.fill_diagonal(m, int(scoring["match"]))
    m[4:, :] = 0
    m[:, 4:] = 0
    return m


def rows_bad(msa: np.ndarray, seqs: List[np.ndarray], gap_code: int) -> int:
    """Rows whose residues, in order, are not their input sequence."""
    res = msa != gap_code
    counts = res.sum(axis=1)
    lens = np.array([len(s) for s in seqs])
    bad = counts != lens
    if bad.any():
        return int(bad.sum())
    flat = msa[res]                          # row-major: row by row
    want = np.concatenate(seqs)
    diff = np.flatnonzero(flat != want)
    if diff.size == 0:
        return 0
    return int(np.unique(np.searchsorted(np.cumsum(lens), diff,
                                         side="right")).size)


def empty_columns(msa: np.ndarray, gap_code: int) -> int:
    return int((msa == gap_code).all(axis=0).sum())


def induced_score(a_row: np.ndarray, b_row: np.ndarray, sub: np.ndarray,
                  gap_code: int, gap_open: int, gap_extend: int) -> int:
    """Affine score of the pairwise alignment two MSA rows induce: each
    maximal run of gap columns on one side costs open + (len - 1) x
    extend."""
    keep = (a_row != gap_code) | (b_row != gap_code)
    a, b = a_row[keep].astype(np.int64), b_row[keep].astype(np.int64)
    state = np.where(b == gap_code, 1, np.where(a == gap_code, 2, 0))
    both = state == 0
    score = int(sub[a[both], b[both]].sum())
    gaps = state != 0
    prev = np.concatenate([[0], state[:-1]])
    opens = int((gaps & (prev != state)).sum())
    return score - gap_open * opens - gap_extend * (int(gaps.sum()) - opens)


def gotoh_scores(pairs: Sequence, sub: np.ndarray, gap_open: int,
                 gap_extend: int, device) -> np.ndarray:
    """Global affine-gap (Gotoh) optimum of each (a, b) code pair, over
    anti-diagonals batched across pairs. An insertion and a deletion may
    not follow each other directly (each opens from a match state)."""
    B = len(pairs)
    if B == 0:
        return np.zeros(0, np.int64)
    dev = torch.device(device)
    la = np.array([len(a) for a, _ in pairs])
    lb = np.array([len(b) for _, b in pairs])
    n, m = max(int(la.max()), 1), max(int(lb.max()), 1)
    S = sub.shape[0]
    A = np.zeros((B, n), np.int64)
    Bt = np.zeros((B, m), np.int64)
    for k, (a, b) in enumerate(pairs):
        A[k, :len(a)] = a
        Bt[k, :len(b)] = b
    A = torch.from_numpy(A).to(dev)
    Bt = torch.from_numpy(Bt).to(dev)
    subt = torch.from_numpy(sub.reshape(-1)).to(dev)
    la_t = torch.from_numpy(la).to(dev)
    ends = torch.from_numpy(la + lb).to(dev)
    go, ge = int(gap_open), int(gap_extend)
    i = torch.arange(n + 1, device=dev)
    neg = torch.full((B, n + 1), NEG, dtype=torch.int64, device=dev)
    # diagonal 0: only (0, 0)
    M1 = neg.clone()
    M1[:, 0] = 0
    X1, Y1 = neg.clone(), neg.clone()
    H2 = neg.clone()                       # max state two diagonals back
    out = torch.full((B,), NEG, dtype=torch.int64, device=dev)
    out = torch.where(ends == 0, torch.zeros_like(out), out)
    a_prev = torch.cat([A[:, :1], A], dim=1)          # a[i-1] at index i
    for d in range(1, int((la + lb).max()) + 1):
        j = d - i                                      # (n + 1,)
        valid = (j >= 0) & (j <= m)
        bj = Bt.gather(1, (j - 1).clamp(0, m - 1).expand(B, n + 1))
        s = subt[a_prev * S + bj]
        diag = torch.cat([neg[:, :1], H2[:, :-1]], dim=1)    # (i-1, j-1)
        M = torch.where(((i >= 1) & (j >= 1) & valid)[None], diag + s, NEG)
        up_m = torch.cat([neg[:, :1], M1[:, :-1]], dim=1)    # (i-1, j)
        up_x = torch.cat([neg[:, :1], X1[:, :-1]], dim=1)
        X = torch.where(((i >= 1) & valid)[None],
                        torch.maximum(up_m - go, up_x - ge), NEG)
        Y = torch.where(((j >= 1) & valid)[None],
                        torch.maximum(M1 - go, Y1 - ge), NEG)
        X = torch.maximum(X, neg)
        Y = torch.maximum(Y, neg)
        H = torch.maximum(M, torch.maximum(X, Y))
        hit = ends == d
        if bool(hit.any()):
            out = torch.where(hit, H.gather(1, la_t[:, None])[:, 0], out)
        H2 = torch.maximum(torch.maximum(M1, X1), Y1)
        M1, X1, Y1 = M, X, Y
    return out.cpu().numpy()


def center_table(center: np.ndarray, k: int, r: int = 4) -> dict:
    """k-mer code -> its first ``r`` start positions in the center
    (windows holding N are skipped); a code is sum c[p + i] 4^i."""
    table: dict = {}
    lc = len(center)
    for p in range(lc - k + 1):
        w = center[p:p + k]
        if (w >= 4).any():
            continue
        code = int((w.astype(np.int64) * (4 ** np.arange(k))).sum())
        hits = table.setdefault(code, [])
        if len(hits) < r:
            hits.append(p)
    return table


def chain(q: np.ndarray, table: dict, lc: int, *, k: int, max_anchors: int,
          max_seg: int):
    """Greedy monotone chaining of k-mer hits: a window's hit is the
    first of its code's positions at or past the chain's end, taken when
    both segments it closes are at most ``max_seg`` long. Returns
    (anchors [(q, c)], ok): ``ok`` is False when the tail is longer than
    ``max_seg`` or no anchor was found (and the pair is not short enough
    for one segment)."""
    lq = len(q)
    q_end = c_end = 0
    anchors = []
    pw = 4 ** np.arange(k)
    for t in range(0, lq - k + 1):
        w = q[t:t + k]
        if (w >= 4).any():
            continue
        hits = table.get(int((w.astype(np.int64) * pw).sum()), ())
        c = next((p for p in hits if p >= c_end), None)
        if c is None or t < q_end or len(anchors) >= max_anchors:
            continue
        if t - q_end > max_seg or c - c_end > max_seg or c + k > lc:
            continue
        anchors.append((t, c))
        q_end, c_end = t + k, c + k
    ok = (lq - q_end <= max_seg) and (lc - c_end <= max_seg) and (
        len(anchors) > 0 or (lq <= max_seg and lc <= max_seg))
    return anchors, ok


def expected_scores(queries: List[np.ndarray], center: np.ndarray,
                    cfg: dict, sub: np.ndarray, device):
    """The score the configuration's pairwise method gives each query
    against the center: a chained pair
    scores its anchors (k matches each) plus the Gotoh optimum of each
    segment between them; a failed chain scores the whole pair's
    optimum."""
    k, go, ge = int(cfg["k"]), int(cfg["gap_open"]), int(cfg["gap_extend"])
    table = center_table(center, k)
    lc = len(center)
    seg_pairs, owners, whole = [], [], []
    score = np.zeros(len(queries), np.int64)
    for idx, q in enumerate(queries):
        anchors, ok = chain(q, table, lc, k=k,
                            max_anchors=int(cfg["max_anchors"]),
                            max_seg=int(cfg["max_seg"]))
        if not ok:
            whole.append(idx)
            continue
        qs = cs = 0
        for t, c in anchors + [(len(q), lc)]:
            if t - qs or c - cs:
                seg_pairs.append((q[qs:t], center[cs:c]))
                owners.append(idx)
            if t < len(q) or c < lc:         # a real anchor, not the end
                score[idx] += int(sub[q[t:t + k], center[c:c + k]].sum())
            qs, cs = t + k, c + k
    seg = gotoh_scores(seg_pairs, sub, go, ge, device)
    np.add.at(score, np.asarray(owners, np.int64), seg)
    full = gotoh_scores([(queries[i], center) for i in whole], sub, go, ge,
                        device)
    score[np.asarray(whole, np.int64)] = full
    return score
