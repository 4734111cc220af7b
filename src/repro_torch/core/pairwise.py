"""Pairwise alignment: Needleman-Wunsch / Smith-Waterman with affine gaps (Gotoh).

The plain PyTorch counterpart of ``repro.core.pairwise``: the DP is a
Python loop over query rows, batched over B pairs, where every in-row
dependency is either elementwise (M, Ix) or a running max (Iy via
``torch.cummax``). The hand-written kernel in ``repro_torch.kernels.sw``
implements the same recurrences; this module is its oracle and the
traceback every backend shares.

State convention (shared with the kernel and the traceback):
  M  = 0  a[i-1] aligned to b[j-1]            (diagonal move)
  IX = 1  a[i-1] aligned to a gap in b        (up move, consumes a)
  IY = 2  b[j-1] aligned to a gap in a        (left move, consumes b)
  FRESH = 3  local-alignment fresh start / origin marker

Direction byte = dirM | dirIx << 2 | dirIy << 3, where
  dirM  in {0,1,2,3}: which state the diagonal max came from (3 = fresh)
  dirIx in {0,1}: 0 = opened from M above, 1 = extended Ix above
  dirIy in {0,1}: 0 = opened from M left,  1 = extended Iy left

All scores are integer-valued float32 (exact up to 2^24), NEG = -1e7.
Every function takes batched tensors: a (B, n), la (B,), b (B, m) — a
broadcast target may be an ``expand``ed view — lb (B,).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -1.0e7
M_ST, IX_ST, IY_ST, FRESH = 0, 1, 2, 3

# the traceback checks for "every pair done" once per this many steps
# (each check is a host sync on a CUDA tensor)
_DONE_CHECK = 32


class AlignResult(NamedTuple):
    score: torch.Tensor      # (B,) f32
    a_row: torch.Tensor      # (B, n+m) int8 aligned a with gaps (gap-padded)
    b_row: torch.Tensor      # (B, n+m) int8 aligned b with gaps
    aln_len: torch.Tensor    # (B,) i32 number of valid leading columns
    start_i: torch.Tensor    # (B,) i32 row where traceback started
    start_j: torch.Tensor    # (B,) i32


class ForwardResult(NamedTuple):
    dirs: torch.Tensor       # (B, n+1, m+1) int8 packed direction bytes
    score: torch.Tensor      # (B,) f32
    start_i: torch.Tensor    # (B,) i32
    start_j: torch.Tensor    # (B,) i32
    start_state: torch.Tensor  # (B,) i32


def _pack(dir_m, dir_ix, dir_iy):
    return (dir_m | (dir_ix << 2) | (dir_iy << 3)).to(torch.int8)


def _shift_right(x, fill):
    """x[:, j-1] at column j, ``fill`` at column 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def forward_rows(a, la, b, lb, sub, gap_open, gap_extend, *, local: bool,
                 freeze: bool):
    """Row-scan Gotoh forward over a batch.

    Returns ``(dir_rows, rec)``: dir_rows (B, n, m+1) int8 for DP rows
    1..n and rec (B, 8) f32 ``[score, start_i, start_j, start_state, 0*4]``.
    ``freeze=True`` keeps the row state fixed past row ``la`` (the kernel's
    semantics); ``freeze=False`` keeps scanning (the reference oracle's).
    The two agree on rows ``<= la`` and on every record field.
    """
    B, n = a.shape
    m = b.shape[1]
    dev = a.device
    go = torch.tensor(float(gap_open), dtype=torch.float32, device=dev)
    ge = torch.tensor(float(gap_extend), dtype=torch.float32, device=dev)
    sub = sub.to(torch.float32)
    S = sub.shape[0]
    la = la.to(torch.int32)
    lb = lb.to(torch.int32)
    jcol = torch.arange(m + 1, dtype=torch.float32, device=dev)
    col = torch.arange(m + 1, device=dev)
    col_valid = col[None, :] <= lb[:, None]
    # out-of-range codes clamp, as the reference's gathers do
    sub_b = sub[:, b.long().clamp(0, S - 1)]                  # (S, B, m)

    m0 = torch.full((B, m + 1), NEG, dtype=torch.float32, device=dev)
    m0[:, 0] = 0.0
    ix0 = torch.full((B, m + 1), NEG, dtype=torch.float32, device=dev)
    iy0 = torch.where(col >= 1, -(go + (jcol - 1.0) * ge),
                      torch.tensor(NEG, device=dev)).expand(B, m + 1)
    m_prev, ix_prev, iy_prev = m0, ix0, iy0
    cap_m, cap_ix, cap_iy = m0, ix0, iy0
    best_v = torch.full((B,), NEG, dtype=torch.float32, device=dev)
    best_i = torch.zeros((B,), dtype=torch.int32, device=dev)
    best_j = torch.zeros((B,), dtype=torch.int32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    bidx = torch.arange(B, device=dev)
    dir_rows = torch.empty((B, n, m + 1), dtype=torch.int8, device=dev)

    for r in range(1, n + 1):
        a_i = a[:, r - 1].long().clamp(0, S - 1)
        s_full = torch.cat([zero_col, sub_b[a_i, bidx]], dim=1)

        h_prev = torch.maximum(m_prev, torch.maximum(ix_prev, iy_prev))
        amax = torch.where(m_prev >= h_prev, M_ST,
                           torch.where(ix_prev >= h_prev, IX_ST, IY_ST))
        h_diag = _shift_right(h_prev, NEG)
        dir_m = _shift_right(amax, M_ST)

        m_new = h_diag + s_full
        if local:
            # fresh start beats extending whenever the diagonal is <= 0;
            # ties prefer fresh so traceback stops at zero-valued cells
            fresh = h_diag <= 0.0
            m_new = torch.where(fresh, s_full, m_new)
            dir_m = torch.where(fresh, FRESH, dir_m)
        m_new[:, 0] = NEG

        ix_open = m_prev - go
        ix_ext = ix_prev - ge
        ix_new = torch.maximum(ix_open, ix_ext)
        dir_ix = (ix_ext > ix_open).to(torch.int64)

        # Iy via running max:  Iy[j] = -go-(j-1)ge + max_{k<=j-1}(M[k]+k*ge)
        cm = torch.cummax(m_new + jcol * ge, dim=1).values
        iy_new = torch.cat([torch.full_like(cm[:, :1], NEG),
                            cm[:, :-1] - go - (jcol[1:] - 1.0) * ge], dim=1)
        m_left = _shift_right(m_new, NEG)
        iy_left = _shift_right(iy_new, NEG)
        dir_iy = (iy_left - ge > m_left - go).to(torch.int64)

        dir_rows[:, r - 1] = _pack(dir_m.to(torch.int64), dir_ix, dir_iy)

        live = (r <= la)[:, None]
        hit = (r == la)[:, None]
        cap_m = torch.where(hit, m_new, cap_m)
        cap_ix = torch.where(hit, ix_new, cap_ix)
        cap_iy = torch.where(hit, iy_new, cap_iy)
        if local:
            row_masked = torch.where(col_valid & live, m_new, NEG)
            jb = torch.argmax(row_masked, dim=1)   # first maximal column
            v = row_masked.gather(1, jb[:, None])[:, 0]
            upd = v > best_v
            best_v = torch.where(upd, v, best_v)
            best_i = torch.where(upd, r, best_i)
            best_j = torch.where(upd, jb.to(torch.int32), best_j)
        if freeze:
            m_prev = torch.where(live, m_new, m_prev)
            ix_prev = torch.where(live, ix_new, ix_prev)
            iy_prev = torch.where(live, iy_new, iy_prev)
        else:
            m_prev, ix_prev, iy_prev = m_new, ix_new, iy_new

    rec = torch.zeros((B, 8), dtype=torch.float32, device=dev)
    if local:
        rec[:, 0] = best_v
        rec[:, 1] = best_i.to(torch.float32)
        rec[:, 2] = best_j.to(torch.float32)
        rec[:, 3] = float(M_ST)
    else:
        jl = lb.long().clamp(0, m)[:, None]
        ends = torch.cat([cap_m.gather(1, jl), cap_ix.gather(1, jl),
                          cap_iy.gather(1, jl)], dim=1)        # (B, 3)
        st = torch.argmax(ends, dim=1)                      # first maximum
        rec[:, 0] = ends.gather(1, st[:, None])[:, 0]
        rec[:, 1] = la.to(torch.float32)
        rec[:, 2] = lb.to(torch.float32)
        rec[:, 3] = st.to(torch.float32)
    return dir_rows, rec


def boundary_row(m: int, device=None) -> torch.Tensor:
    """Packed direction row 0: FRESH everywhere, Iy opened from M at j=1."""
    dir_iy0 = (torch.arange(m + 1, device=device) != 1).to(torch.int64)
    return (FRESH | (dir_iy0 << 3)).to(torch.int8)


def forward_result(dir_rows, rec) -> ForwardResult:
    """Prepend row 0 and unpack the record into a ``ForwardResult``."""
    B, n, m1 = dir_rows.shape
    dirs = torch.empty((B, n + 1, m1), dtype=torch.int8,
                       device=dir_rows.device)
    dirs[:, 0] = boundary_row(m1 - 1, dir_rows.device)
    dirs[:, 1:] = dir_rows
    return ForwardResult(dirs, rec[:, 0], rec[:, 1].to(torch.int32),
                         rec[:, 2].to(torch.int32), rec[:, 3].to(torch.int32))


def gotoh_forward(a, la, b, lb, sub, gap_open, gap_extend, *, local=False
                  ) -> ForwardResult:
    """Fill the DP, returning packed directions + traceback start.

    a: (B, n) int8 codes, la: (B,) lengths; b: (B, m) int8, lb: (B,);
    sub: (S, S) f32.
    """
    dir_rows, rec = forward_rows(a, la, b, lb, sub, gap_open, gap_extend,
                                 local=local, freeze=False)
    return forward_result(dir_rows, rec)


def traceback(a, b, fwd: ForwardResult, gap_code: int):
    """Walk packed directions back to aligned pairs (gap-padded rows).

    Batched over B; the walk stops once every pair is done (the reference
    runs a fixed ``n + m`` steps — done pairs never change, so the rows
    are the same). Returns ``(a_row, b_row, aln_len)``.
    """
    B, n = a.shape
    m = b.shape[1]
    out_len = n + m
    dev = a.device
    dirf = fwd.dirs.reshape(B, (n + 1) * (m + 1))
    i = fwd.start_i.to(torch.int64).clone()
    j = fwd.start_j.to(torch.int64).clone()
    st = fwd.start_state.to(torch.int64).clone()
    done = (i == 0) & (j == 0)
    k = torch.zeros((B,), dtype=torch.int64, device=dev)
    out_a = torch.full((B, out_len), gap_code, dtype=torch.int8, device=dev)
    out_b = torch.full((B, out_len), gap_code, dtype=torch.int8, device=dev)
    gap = torch.tensor(gap_code, dtype=torch.int8, device=dev)
    along = a.long()
    blong = b.long()

    for t in range(out_len):
        if t % _DONE_CHECK == 0 and bool(done.all()):
            break
        flat = (i * (m + 1) + j).clamp(0, dirf.shape[1] - 1)  # as jnp clamps
        byte = dirf.gather(1, flat[:, None])[:, 0].to(torch.int64)
        dir_m = byte & 3
        dir_ix = (byte >> 2) & 1
        dir_iy = (byte >> 3) & 1

        is_m = st == M_ST
        is_ix = st == IX_ST
        is_iy = st == IY_ST
        ca = torch.where(is_m | is_ix, along.gather(
            1, (i - 1).clamp(0, max(n - 1, 0))[:, None])[:, 0].to(torch.int8),
            gap)
        cb = torch.where(is_m | is_iy, blong.gather(
            1, (j - 1).clamp(0, max(m - 1, 0))[:, None])[:, 0].to(torch.int8),
            gap)
        kk = k.clamp(max=out_len - 1)[:, None]
        out_a.scatter_(1, kk, torch.where(done, out_a.gather(1, kk)[:, 0],
                                          ca)[:, None])
        out_b.scatter_(1, kk, torch.where(done, out_b.gather(1, kk)[:, 0],
                                          cb)[:, None])

        ni = torch.where(is_m | is_ix, i - 1, i)
        nj = torch.where(is_m | is_iy, j - 1, j)
        nst = torch.where(is_m, dir_m,
                          torch.where(is_ix,
                                      torch.where(dir_ix == 1, IX_ST, M_ST),
                                      torch.where(dir_iy == 1, IY_ST, M_ST)))
        fresh_stop = is_m & (dir_m == FRESH)
        ndone = done | fresh_stop | ((ni == 0) & (nj == 0))
        k = torch.where(done, k, k + 1)
        i = torch.where(done, i, ni)
        j = torch.where(done, j, nj)
        st = torch.where(done, st, nst)
        done = ndone

    # the walk emitted columns in reverse; un-reverse the first k entries
    p = torch.arange(out_len, device=dev)[None, :]
    src = (k[:, None] - 1 - p).clamp(min=0)
    keep = p < k[:, None]
    a_row = torch.where(keep, out_a.gather(1, src), gap)
    b_row = torch.where(keep, out_b.gather(1, src), gap)
    return a_row, b_row, k.to(torch.int32)


def align_pair(a, la, b, lb, sub, *, gap_open, gap_extend, local=False,
               gap_code=5) -> AlignResult:
    """Align row i of ``a`` to row i of ``b`` (batched) with the plain
    forward."""
    fwd = gotoh_forward(a, la, b, lb, sub, gap_open, gap_extend, local=local)
    a_row, b_row, k = traceback(a, b, fwd, gap_code)
    return AlignResult(fwd.score, a_row, b_row, k, fwd.start_i, fwd.start_j)


def align_many_to_one(A, lens, b, lb, sub, *, gap_open, gap_extend,
                      local=False, gap_code=5) -> AlignResult:
    """Queries A (B, n) against one broadcast target b (m,) — HAlign-II's
    map(1) stage with the center as the broadcast variable."""
    B = A.shape[0]
    return align_pair(A, lens, b[None, :].expand(B, b.shape[0]),
                      torch.full((B,), int(lb), dtype=torch.int32,
                                 device=A.device),
                      sub, gap_open=gap_open, gap_extend=gap_extend,
                      local=local, gap_code=gap_code)
