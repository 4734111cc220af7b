"""The banded Gotoh recurrence as plain PyTorch, batched over pairs.

The counterpart of ``repro.kernels.banded.ref``: the band geometry, the
row recurrence, the edge-pressure overflow detector and one traceback
step. ``align.banded`` loops them over rows and steps; they are the plain
version of both banded kernels (``csrc/banded_forward.cu``,
``csrc/banded_fused.cu``), which compute the same operations in the same
order. Every score is an integer-valued float32 above ``NEG``, so the
same order gives the same bits.

Shapes: band state is ``(B, W)`` float32, per-pair scalars are ``(B,)``
(lengths and band offsets int64, flags bool). The band geometry is
documented in ``align/banded.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.pairwise import FRESH, IX_ST, IY_ST, M_ST, NEG, _pack


class BandedForward(NamedTuple):
    dirs: torch.Tensor          # (B, n, W) int8 packed bytes, DP rows 1..n
    score: torch.Tensor         # (B,) f32 global score at (la, lb)
    start_i: torch.Tensor       # (B,) i32 == la
    start_j: torch.Tensor       # (B,) i32 == lb
    start_state: torch.Tensor   # (B,) i32
    edge: torch.Tensor          # (B,) bool: a live row's band was pressed


def band_lo(i, la, lb, band: int):
    """Leftmost absolute column stored for DP row ``i`` (per pair)."""
    c = torch.where(la == 0, lb,
                    torch.div(i * lb, la.clamp(min=1), rounding_mode="floor"))
    return c - band // 2


def band_row_init(la, lb, go, ge, *, band: int):
    """Row-0 band state (m0, ix0, iy0) (B, W), the end-cell capture
    (B, 3) and the row best (B,)."""
    W = band
    dev = la.device
    offs = torch.arange(W, device=dev)
    mid = W // 2
    lo0 = band_lo(torch.zeros_like(la), la, lb, W)
    j0 = lo0[:, None] + offs
    negs = torch.full(j0.shape, NEG, dtype=torch.float32, device=dev)
    m0 = torch.where(j0 == 0, torch.zeros_like(negs), negs)
    ix0 = negs.clone()
    iy0 = torch.where((j0 >= 1) & (j0 <= lb[:, None]),
                      -(go + (j0.to(torch.float32) - 1.0) * ge), negs)
    cap0 = torch.stack([m0[:, mid], ix0[:, mid], iy0[:, mid]], dim=1)
    h0 = torch.where((j0 >= 0) & (j0 <= lb[:, None]),
                     torch.maximum(m0, iy0), negs)
    return m0, ix0, iy0, cap0, h0.amax(dim=1)


def _shifted(v, sh, fill):
    """Previous-row vector read at offset ``o + sh`` (per pair), ``fill``
    outside the band."""
    W = v.shape[1]
    idx = torch.arange(W, device=v.device)[None, :] + sh[:, None]
    ok = (idx >= 0) & (idx < W)
    got = v.gather(1, idx.clamp(0, W - 1))
    return torch.where(ok, got, torch.full_like(got, fill))


def band_row_update(m_prev, ix_prev, iy_prev, a_i, b, lo_prev, lo_i, sub,
                    go, ge, lb):
    """One banded Gotoh DP row for every pair.

    a_i (B,) codes of this row, b (B, m) targets, lo_prev/lo_i (B,) band
    offsets, lb (B,). Returns (m_new, ix_new, iy_new, dirs, h_new, h_prev,
    s) as the reference does; ``h_new``/``h_prev``/``s`` feed
    ``edge_pressure``.
    """
    B, W = m_prev.shape
    m = b.shape[1]
    S = sub.shape[0]
    dev = m_prev.device
    offs = torch.arange(W, device=dev)
    offs_f = offs.to(torch.float32)
    s = lo_i - lo_prev                       # band slide (>= 0)
    j = lo_i[:, None] + offs                 # absolute columns this row
    lbc = lb[:, None]

    h_prev = torch.maximum(m_prev, torch.maximum(ix_prev, iy_prev))
    amax = torch.where(m_prev >= h_prev, M_ST,
                       torch.where(ix_prev >= h_prev, IX_ST, IY_ST))
    h_diag = _shifted(h_prev, s - 1, NEG)
    amax_diag = _shifted(amax, s - 1, M_ST)
    m_up = _shifted(m_prev, s, NEG)
    ix_up = _shifted(ix_prev, s, NEG)

    # out-of-range codes clamp, as the reference's gathers do
    bj = b.gather(1, (j - 1).clamp(0, m - 1)).long().clamp(0, S - 1)
    s_row = sub[a_i.long().clamp(0, S - 1)[:, None], bj]
    negs = torch.full((B, W), NEG, dtype=torch.float32, device=dev)
    in_mat = (j >= 1) & (j <= lbc)
    m_new = torch.where(in_mat, h_diag + s_row, negs)
    dir_m = amax_diag

    ix_open = m_up - go
    ix_ext = ix_up - ge
    in_row = (j >= 0) & (j <= lbc)
    ix_new = torch.where(in_row, torch.maximum(ix_open, ix_ext), negs)
    dir_ix = (ix_ext > ix_open).to(torch.int64)

    # Iy running max within the row; band offsets stand in for absolute
    # columns (the lo_i·ge term cancels exactly in f32 integer range)
    cm = torch.cummax(m_new + offs_f * ge, dim=1).values
    iy_new = torch.cat([negs[:, :1],
                        cm[:, :-1] - go - (offs_f[1:] - 1.0) * ge], dim=1)
    iy_new = torch.where(in_mat, iy_new, negs)
    m_left = torch.cat([negs[:, :1], m_new[:, :-1]], dim=1)
    iy_left = torch.cat([negs[:, :1], iy_new[:, :-1]], dim=1)
    dir_iy = (iy_left - ge > m_left - go).to(torch.int64)

    dirs = _pack(dir_m, dir_ix, dir_iy)
    h_new = torch.where(in_row, torch.maximum(m_new,
                                              torch.maximum(ix_new, iy_new)),
                        negs)
    return m_new, ix_new, iy_new, dirs, h_new, h_prev, s


def edge_pressure(h_new, h_prev, hb_prev, s, margin):
    """Band-overflow detector for one row (see ``align/banded.py``).

    A competitive cell (within ``margin`` of the row best) in an exit
    zone — offset 0, the slide-clipped right rim, or a previous-row cell
    about to slide out of storage — flags the pair. Returns (comp (B,)
    bool, hb (B,) the row best).
    """
    W = h_new.shape[1]
    offs = torch.arange(W, device=h_new.device)[None, :]
    hb = h_new.amax(dim=1)
    zone = (offs == 0) | (offs >= W - s.clamp(min=1)[:, None])
    comp_cur = ((zone & (h_new >= (hb - margin)[:, None])).any(dim=1)
                & (hb > NEG / 2))
    # bottom-left exit: previous-row cells slid out of storage this row
    comp_prev = (((offs < s[:, None])
                  & (h_prev >= (hb_prev - margin)[:, None])).any(dim=1)
                 & (hb_prev > NEG / 2))
    return comp_cur | comp_prev, hb


def trace_step_math(i, j, o, st, done, byte_band, a_im1, b_jm1, lb,
                    gap_code: int, band: int):
    """One traceback step for every pair — the pure walk logic.

    The caller fetches the band direction byte and the two sequence
    characters; this decides the move. Returns (ni, nj, nst, done, ndone,
    lost, edge_hit, ca, cb): ``done`` is the post-``lost`` write gate of
    this step and ``ndone`` the carry.
    """
    W = band
    in_band = (o >= 0) & (o < W) & (i >= 1)
    # boundary cells are pure gap runs with closed-form directions; they
    # are not stored in the band
    byte_row0 = FRESH | (torch.where(j == 1, 0, 1) << 3)
    byte_col0 = M_ST | (torch.where(i == 1, 0, 1) << 2)
    byte = torch.where(i == 0, byte_row0,
                       torch.where(j == 0, byte_col0, byte_band))

    interior = (i > 0) & (j > 0)
    lost = (~done) & interior & (~in_band)
    # edge cells whose clipped neighbour is a real DP cell: a wider band
    # could score higher
    edge_hit = ((~done) & interior & in_band
                & ((o == 0) | ((o == W - 1) & (j < lb))))
    done = done | lost

    dir_m = byte & 3
    dir_ix = (byte >> 2) & 1
    dir_iy = (byte >> 3) & 1
    is_m = st == M_ST
    is_ix = st == IX_ST
    is_iy = st == IY_ST
    gap = torch.full_like(a_im1, gap_code)
    ca = torch.where(is_m | is_ix, a_im1, gap)
    cb = torch.where(is_m | is_iy, b_jm1, gap)

    ni = torch.where(is_m | is_ix, i - 1, i)
    nj = torch.where(is_m | is_iy, j - 1, j)
    nst = torch.where(is_m, dir_m,
                      torch.where(is_ix, torch.where(dir_ix == 1, IX_ST, M_ST),
                                  torch.where(dir_iy == 1, IY_ST, M_ST)))
    ndone = done | ((ni == 0) & (nj == 0))
    return ni, nj, nst, done, ndone, lost, edge_hit, ca, cb


# the traceback checks for "every pair done" once per this many steps
# (each check is a host sync on a CUDA tensor)
_DONE_CHECK = 32


def banded_forward(a, la, b, lb, sub, gap_open, gap_extend, *,
                   band: int) -> BandedForward:
    """Banded Gotoh forward over a batch: the loop over DP rows.

    a (B, n) int8, la (B,), b (B, m) int8 with m >= 1, lb (B,), sub (S, S)
    f32. The band state advances through every row, past ``la`` too, as
    in the reference; only live rows feed the capture and the flags.
    """
    B, n = a.shape
    W = band
    mid = W // 2
    go = float(gap_open)
    ge = float(gap_extend)
    sub = sub.to(torch.float32)
    la = la.to(torch.int64)
    lb = lb.to(torch.int64)
    margin = sub.max()                       # one diagonal step of headroom
    if b.shape[1] == 0:                      # lb == 0: no cell reads b
        b = torch.zeros((B, 1), dtype=b.dtype, device=b.device)

    m_p, ix_p, iy_p, cap, hb_prev = band_row_init(la, lb, go, ge, band=W)
    lo_prev = band_lo(torch.zeros_like(la), la, lb, W)
    edge = torch.zeros((B,), dtype=torch.bool, device=a.device)
    dirs = torch.empty((B, n, W), dtype=torch.int8, device=a.device)
    for i in range(1, n + 1):
        lo_i = band_lo(torch.full_like(la, i), la, lb, W)
        m_p, ix_p, iy_p, dirs[:, i - 1], h_new, h_prev, s = band_row_update(
            m_p, ix_p, iy_p, a[:, i - 1], b, lo_prev, lo_i, sub, go, ge, lb)
        hit = (la == i)[:, None]             # end cell (la, lb) sits at mid
        cap = torch.where(hit, torch.stack([m_p[:, mid], ix_p[:, mid],
                                            iy_p[:, mid]], dim=1), cap)
        live = la >= i
        comp, hb = edge_pressure(h_new, h_prev, hb_prev, s, margin)
        edge = edge | (live & comp)
        hb_prev = torch.where(live, hb, hb_prev)
        lo_prev = lo_i
    st = torch.argmax(cap, dim=1)            # first maximum: M, Ix, Iy
    i32 = torch.int32
    return BandedForward(dirs, cap.gather(1, st[:, None])[:, 0], la.to(i32),
                         lb.to(i32), st.to(i32), edge)


def banded_traceback(a, b, fwd: BandedForward, gap_code: int, *,
                     band: int):
    """Walk the banded directions back to gap-padded aligned rows.

    Returns (a_row, b_row (B, n+m) int8, aln_len (B,) i32, ok (B,) bool);
    ``ok`` is False when the path left the band, touched a band edge next
    to real (unstored) cells, or the score is NEG-degenerate. The walk
    stops once every pair is done; the reference runs a fixed ``n + m``
    steps, in which done pairs never change.
    """
    B, n = a.shape
    m = b.shape[1]
    W = band
    out_len = n + m
    dev = a.device
    dirf = fwd.dirs.reshape(B, n * W)
    la = fwd.start_i.to(torch.int64)
    lb = fwd.start_j.to(torch.int64)
    i, j = la.clone(), lb.clone()
    st = fwd.start_state.to(torch.int64)
    done = (i == 0) & (j == 0)
    edge = torch.zeros((B,), dtype=torch.bool, device=dev)
    oob = torch.zeros((B,), dtype=torch.bool, device=dev)
    k = torch.zeros((B,), dtype=torch.int64, device=dev)
    out_a = torch.full((B, out_len), gap_code, dtype=torch.int8, device=dev)
    out_b = torch.full((B, out_len), gap_code, dtype=torch.int8, device=dev)
    gap = torch.full((B, 1), gap_code, dtype=torch.int8, device=dev)
    ap = torch.cat([a, gap], dim=1)          # a column to clamp into when
    bp = torch.cat([b, gap], dim=1)          # n or m is 0

    for t in range(out_len):
        if t % _DONE_CHECK == 0 and bool(done.all()):
            break
        o = j - band_lo(i, la, lb, W)
        byte_band = dirf.gather(
            1, ((i - 1) * W + o).clamp(0, max(n * W - 1, 0))[:, None]
        )[:, 0].long() if n else torch.zeros_like(i)
        a_im1 = ap.gather(1, (i - 1).clamp(0, max(n - 1, 0))[:, None])[:, 0]
        b_jm1 = bp.gather(1, (j - 1).clamp(0, max(m - 1, 0))[:, None])[:, 0]
        ni, nj, nst, done, ndone, lost, edge_hit, ca, cb = trace_step_math(
            i, j, o, st, done, byte_band, a_im1, b_jm1, lb, gap_code, W)
        oob = oob | lost
        edge = edge | edge_hit
        kk = k.clamp(max=out_len - 1)[:, None]
        out_a.scatter_(1, kk, torch.where(done, out_a.gather(1, kk)[:, 0],
                                          ca)[:, None])
        out_b.scatter_(1, kk, torch.where(done, out_b.gather(1, kk)[:, 0],
                                          cb)[:, None])
        k = torch.where(done, k, k + 1)
        i = torch.where(done, i, ni)
        j = torch.where(done, j, nj)
        st = torch.where(done, st, nst)
        done = ndone

    ok = (~edge) & (~oob) & (~fwd.edge) & (fwd.score > NEG / 2)
    # the walk emitted columns in reverse; un-reverse the first k entries
    # (the reference's roll(flip(x), k - out_len))
    p = torch.arange(out_len, device=dev)[None, :]
    src = (k[:, None] - 1 - p).clamp(min=0)
    keep = p < k[:, None]
    a_row = torch.where(keep, out_a.gather(1, src), gap)
    b_row = torch.where(keep, out_b.gather(1, src), gap)
    return a_row, b_row, k.to(torch.int32), ok
