"""Trie tree -> k-mer index: the dense-table form of HAlign's trie.

Every length-k window of the center is encoded as a base-4 integer and
scattered (min = first occurrence) into a 4^k table. Queries compute their
own rolling codes, probe the table with one gather, and greedily chain
monotone hits into anchors. All integer math is int32, as in the reference,
and every gather index is clamped where the reference's gathers clamp.
Functions take a batch of queries ``(B, n)`` with lengths ``(B,)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

EMPTY = 2**30


class Anchors(NamedTuple):
    q_pos: torch.Tensor    # (B, A) i32 anchor start in query
    c_pos: torch.Tensor    # (B, A) i32 anchor start in center
    count: torch.Tensor    # (B,) i32 number of accepted anchors
    ok: torch.Tensor       # (B,) bool: every segment <= max_seg


def kmer_codes(seq, length, k: int):
    """Rolling base-4 codes (B, n-k+1) int32; invalid windows (N/gap or
    beyond ``length``) -> -1. A buffer shorter than ``k`` has no windows:
    the result is (B, 0)."""
    B, n = seq.shape
    if n < k:
        return torch.full((B, 0), -1, dtype=torch.int32, device=seq.device)
    w = n - k + 1
    s = seq.to(torch.int32)
    codes = torch.zeros((B, w), dtype=torch.int32, device=seq.device)
    valid = torch.ones((B, w), dtype=torch.bool, device=seq.device)
    for i in range(k):
        win = s[:, i:i + w]
        codes += win * (4 ** i)
        valid &= win < 4
    pos = torch.arange(w, device=seq.device)
    valid &= pos[None, :] <= (length.to(torch.int32)[:, None] - k)
    return torch.where(valid, codes, -1)


def build_center_index(center, lc, *, k: int, r: int = 4):
    """(4^k, r) int32 table: code -> first r positions in the center
    (EMPTY pad) — the dense-array equivalent of a trie node's position
    list. ``center`` is (n,) int8, ``lc`` its length."""
    return build_tables(center[None, :],
                        torch.as_tensor([int(lc)], device=center.device),
                        k=k, r=r)[0]


def build_tables(seqs, lens, *, k: int, r: int = 4):
    """``build_center_index`` for every row of ``seqs`` (D, n) with
    lengths ``lens`` (D,) at once: (D, 4^k, r) int32 (a search index's
    per-row tables)."""
    dev = seqs.device
    D = seqs.shape[0]
    codes = kmer_codes(seqs, lens, k)                       # (D, w)
    size = 4 ** k
    pos = torch.arange(codes.shape[1], dtype=torch.int32,
                       device=dev).expand(D, codes.shape[1])
    valid = codes >= 0
    cols = []
    floor = torch.full((D, size), -1, dtype=torch.int32, device=dev)
    for _ in range(r):
        live = valid & (pos > floor.gather(1, codes.clamp(min=0).long()))
        # slot ``size`` collects the dropped windows and is cropped away
        tbl = torch.full((D, size + 1), EMPTY, dtype=torch.int32, device=dev)
        idx = torch.where(live, codes, size).long()
        tbl.scatter_reduce_(1, idx, pos, reduce="amin", include_self=True)
        tbl = tbl[:, :size]
        cols.append(tbl)
        floor = tbl
    return torch.stack(cols, dim=2)


def chain_anchors(q, lq, table, lc, *, k: int, stride: int, max_anchors: int,
                  max_seg: int) -> Anchors:
    """Greedy monotone chaining of k-mer hits (the trie-walk equivalent).

    Accept hit (t, c) iff it extends the chain (t >= q_end, c >= c_end)
    and the inter-anchor segments it closes are both <= max_seg. ``ok`` is
    False when the final tail exceeds max_seg or no anchor coverage was
    achieved — the driver then realigns the pair with full DP.

    ``table`` is one (4^k, r) center table for every query (the MSA
    stage) or a (B, 4^k, r) table per query (the search seed stage, each
    pair's DB row); ``lc`` is one target length or a (B,) tensor of them.
    """
    B, n = q.shape
    dev = q.device
    lq = lq.to(torch.int32)
    if torch.is_tensor(lc) and lc.dim() == 1:
        lc = lc.to(device=dev, dtype=torch.int32)
    else:
        lc = int(lc)
    A = max_anchors
    zeros = torch.zeros((B, A), dtype=torch.int32, device=dev)
    codes = kmer_codes(q, lq, k)
    if codes.shape[1] == 0:
        # no windows, so no chain — still ok when the whole rectangle fits
        # one full-DP segment
        ok = (lq <= max_seg) & (lc <= max_seg)
        return Anchors(zeros, zeros.clone(),
                       torch.zeros((B,), dtype=torch.int32, device=dev), ok)
    idx = codes.clamp(min=0).long()
    hits = (table[idx] if table.dim() == 2 else
            table[torch.arange(B, device=dev)[:, None], idx])
    cand = torch.where((codes >= 0)[:, :, None], hits, EMPTY)     # (B, T, r)
    q_end = torch.zeros((B,), dtype=torch.int32, device=dev)
    c_end = torch.zeros((B,), dtype=torch.int32, device=dev)
    cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    aq = zeros.clone()
    ac = zeros.clone()
    for t in range(0, codes.shape[1], stride):
        cs = cand[:, t]
        c = torch.where(cs >= c_end[:, None], cs, EMPTY).amin(dim=1)
        accept = ((c != EMPTY) & (t >= q_end) & (c >= c_end)
                  & (t - q_end <= max_seg) & (c - c_end <= max_seg)
                  & (cnt < A) & (t + k <= lq) & (c + k <= lc))
        slot = cnt.clamp(max=A - 1).long()[:, None]
        aq.scatter_(1, slot, torch.where(accept, t, aq.gather(1, slot)[:, 0]
                                         )[:, None])
        ac.scatter_(1, slot, torch.where(accept, c, ac.gather(1, slot)[:, 0]
                                         )[:, None])
        q_end = torch.where(accept, t + k, q_end)
        c_end = torch.where(accept, c + k, c_end)
        cnt = torch.where(accept, cnt + 1, cnt)
    tail_ok = ((lq - q_end) <= max_seg) & ((lc - c_end) <= max_seg)
    # cnt == 0 is still a usable chain when the whole pair fits one DP
    # segment (short queries, fragments below the k-mer width)
    ok = tail_ok & ((cnt > 0) | ((lq <= max_seg) & (lc <= max_seg)))
    return Anchors(aq, ac, cnt, ok)


def segment_bounds(anchors: Anchors, lq, lc, *, k: int):
    """Start/length of the A+1 inter-anchor segments in query and center,
    each (B, A+1) int32."""
    B, A = anchors.q_pos.shape
    dev = anchors.q_pos.device
    s = torch.arange(A + 1, device=dev)[None, :]
    prev = (s - 1).clamp(min=0).expand(B, A + 1)
    nxt = s.clamp(max=A - 1).expand(B, A + 1)
    prev_q_end = torch.where(s == 0, 0, anchors.q_pos.gather(1, prev) + k)
    prev_c_end = torch.where(s == 0, 0, anchors.c_pos.gather(1, prev) + k)
    cnt = anchors.count[:, None]
    lq = lq.to(torch.int32)[:, None]
    next_q = torch.where(s < cnt, anchors.q_pos.gather(1, nxt), lq)
    next_c = torch.where(s < cnt, anchors.c_pos.gather(1, nxt), int(lc))
    live = s <= cnt                     # segments past the tail are empty
    q_len = torch.where(live, (next_q - prev_q_end).clamp(min=0), 0)
    c_len = torch.where(live, (next_c - prev_c_end).clamp(min=0), 0)
    q_start = torch.where(live, prev_q_end, 0)
    c_start = torch.where(live, prev_c_end, 0)
    i32 = torch.int32
    return q_start.to(i32), q_len.to(i32), c_start.to(i32), c_len.to(i32)
