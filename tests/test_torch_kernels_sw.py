"""Port parity: the Gotoh forward kernel wrapper against the Pallas kernel.

On a CPU tensor ``repro_torch.kernels.sw.ops.gotoh_forward`` runs the
kernel's plain version; it must reproduce the reference Pallas kernel
(run in interpret mode) exactly: the full (B, n+1, m+1) direction tensor
— rows past ``la`` included, where the row state freezes — and every
record field. The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alphabet as jab
from repro.kernels.sw.ops import gotoh_forward_pallas
from repro_torch.kernels.sw import ops


def _case(seed, B, n, m, n_chars=4):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, n_chars, (B, n)).astype(np.int8)
    Bm = rng.integers(0, n_chars, (B, m)).astype(np.int8)
    lens = np.stack([rng.integers(0, n + 1, B),
                     rng.integers(0, m + 1, B)], 1).astype(np.int32)
    lens[0] = (0, m)
    lens[1] = (n, 0)
    lens[2] = (1, 1)
    return A, Bm, lens


def _compare(A, Bm, lens, sub, go, local, block_rows):
    ref = gotoh_forward_pallas(jnp.asarray(A), jnp.asarray(Bm),
                               jnp.asarray(lens), jnp.asarray(sub),
                               gap_open=go, gap_extend=1, local=local,
                               block_rows=block_rows, interpret=True)
    out = ops.gotoh_forward(torch.from_numpy(A), torch.from_numpy(Bm),
                            torch.from_numpy(lens), torch.from_numpy(sub),
                            gap_open=go, gap_extend=1, local=local)
    for name in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(out, name).numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("B,n,m,block", [(4, 32, 48, 16), (3, 40, 24, 32)])
@pytest.mark.parametrize("local", [False, True])
def test_plain_kernel_matches_pallas_dna(B, n, m, block, local):
    A, Bm, lens = _case(B * n + local, B, n, m)
    sub = np.asarray(jab.dna_matrix(), np.float32)
    _compare(A, Bm, lens, sub, 3, local, block)


@pytest.mark.parametrize("local", [False, True])
def test_plain_kernel_matches_pallas_blosum(local):
    A, Bm, lens = _case(5, 3, 24, 20, n_chars=21)
    sub = np.asarray(jab.blosum62(), np.float32)
    _compare(A, Bm, lens, sub, 11, local, 16)


def test_broadcast_target_matches_per_pair_target():
    A, Bm, lens = _case(9, 5, 20, 17)
    lens[:, 1] = 15
    a = torch.from_numpy(A)
    sub = torch.as_tensor(np.asarray(jab.dna_matrix(), np.float32))
    b1 = torch.from_numpy(Bm[:1])
    wide = ops.gotoh_forward(a, b1.expand(5, 17), torch.from_numpy(lens),
                             sub, gap_open=3, gap_extend=1)
    full = ops.gotoh_forward(a, b1.repeat(5, 1), torch.from_numpy(lens),
                             sub, gap_open=3, gap_extend=1)
    for x, y in zip(wide, full):
        assert torch.equal(x, y)


def test_wrapper_rejects_bad_inputs_and_counts_no_cpu_launch():
    a = torch.zeros((2, 8), dtype=torch.int8)
    b = torch.zeros((2, 6), dtype=torch.int8)
    lens = torch.tensor([[8, 6], [4, 3]], dtype=torch.int32)
    sub = torch.zeros((5, 5), dtype=torch.float32)
    before = ops.launches
    ops.gotoh_forward(a, b, lens, sub, gap_open=3, gap_extend=1)
    assert ops.launches == before
    with pytest.raises(TypeError):
        ops.gotoh_forward(a.int(), b, lens, sub, gap_open=3, gap_extend=1)
    with pytest.raises(ValueError):
        ops.gotoh_forward(a, b, lens.long(), sub, gap_open=3, gap_extend=1)
    with pytest.raises(ValueError):
        ops.gotoh_forward(a, b[:1], lens, sub, gap_open=3, gap_extend=1)
    with pytest.raises(ValueError):
        ops.gotoh_forward(a, b, lens, sub[:, :4], gap_open=3, gap_extend=1)


# ---------------------------------------------------------------- the kernel's
# order of work (csrc/sw_forward.cu), modelled in numpy float32 at a small
# strip: LANES lanes of COLS columns. Strips left to right with the right
# edge carried through a workspace; per row the lanes' Iy totals in offset
# form, an inclusive max-scan over lanes and a sequential carry inside each
# lane, seeded at -inf for column 1; local bests per column, reduced once.

F32 = np.float32
NEG = F32(-1.0e7)
M_ST, IX_ST, IY_ST, FRESH = 0, 1, 2, 3


def _h_amax(mv, xv, yv):
    h = np.maximum(mv, np.maximum(xv, yv))
    am = np.where(mv >= h, M_ST, np.where(xv >= h, IX_ST, IY_ST))
    return h, am


def _row0(j, go, ge):
    j = np.asarray(j)
    mv = np.where(j == 0, F32(0), NEG).astype(F32)
    xv = np.full(j.shape, NEG, F32)
    yv = np.where(j >= 1, -(go + (j - 1).astype(F32) * ge), NEG).astype(F32)
    return mv, xv, yv


def _beats(x, y):
    """(v, i, j) x beats y: larger value, then smaller row, then column."""
    return x[0] > y[0] or (x[0] == y[0] and (x[1], x[2]) < (y[1], y[2]))


def _kernel_model(A, Bm, lens, sub, go, ge, local, lanes=4, cols=2):
    B, n = A.shape
    m = Bm.shape[1]
    S = sub.shape[0]
    go, ge = F32(go), F32(ge)
    sub = sub.astype(F32)
    W = lanes * cols
    strips = -(-(m + 1) // W)
    diy01 = int((NEG - ge) > (NEG - go))
    dirs = np.zeros((B, n + 1, m + 1), np.int8)
    dirs[:, 0] = FRESH | ((np.arange(m + 1) != 1) << 3)
    rec = np.zeros((B, 8), F32)
    for p in range(B):
        la, lb = int(lens[p, 0]), int(lens[p, 1])
        lbc, lbm, live = min(max(lb, 0), m), min(lb, m), min(max(la, 0), n)
        edge = np.zeros((n, 3), F32)            # the pair slot's workspace
        lane_best = [(NEG, 0, 0)] * lanes
        for s in range(strips):
            j = s * W + np.arange(W)
            inside = j <= m
            code = np.where((j >= 1) & inside,
                            np.clip(Bm[p, np.clip(j - 1, 0, max(m - 1, 0))]
                                    if m else 0, 0, S - 1), 0)
            kc = (j + 1).astype(F32) * ge - go
            mp, xp, yp = _row0(j, go, ge)
            cbv = np.where(j <= lbm, NEG, F32(np.inf)).astype(F32)
            cbr = np.zeros(W, np.int64)
            eh, eam = (NEG, M_ST)
            if s > 0:
                eh, eam = _h_amax(*_row0(s * W - 1, go, ge))
            for r in range(1, n + 1):
                if s > 0:
                    eM, eX, eY = edge[r - 1]
                    e_iy = max(eM - go, eY - ge)
                    e_dy = int((eY - ge) > (eM - go))
                    xh, xam = _h_amax(eM, eX, eY)
                else:
                    e_iy, e_dy, xh, xam = F32(-np.inf), diy01, NEG, M_ST
                srow = sub[min(max(int(A[p, r - 1]), 0), S - 1)]
                h, am = _h_amax(mp, xp, yp)
                hd = np.concatenate([[eh], h[:-1]]).astype(F32)
                d = np.concatenate([[eam], am[:-1]])
                sc = srow[code]
                mv = hd + sc
                if local:
                    fresh = hd <= 0
                    mv = np.where(fresh, sc, mv).astype(F32)
                    d = np.where(fresh, FRESH, d)
                if s == 0:
                    mv[0] = NEG
                ixo, ixe = mp - go, xp - ge
                ixn = np.maximum(ixo, ixe)
                T = (mv + kc).reshape(lanes, cols).max(axis=1)
                T[0] = max(T[0], e_iy + F32(s * W) * ge)
                incl = np.maximum.accumulate(T)
                iy = np.zeros(W, F32)
                dy = np.zeros(W, np.int64)
                for ln in range(lanes):
                    c0 = ln * cols
                    if ln == 0:
                        iy[c0], dy[c0] = e_iy, e_dy
                    else:
                        iy[c0] = incl[ln - 1] - F32(j[c0]) * ge
                        dy[c0] = int(iy[c0] > mv[c0 - 1] - go)
                    for c in range(c0 + 1, c0 + cols):
                        opn, ext = mv[c - 1] - go, iy[c - 1] - ge
                        iy[c] = max(opn, ext)
                        dy[c] = int(ext > opn)
                if s == 0:
                    iy[0] = NEG
                    dy[1] = diy01
                byte = d | ((ixe > ixo) << 2) | (dy << 3)
                dirs[p, r, j[inside]] = byte[inside]
                if s < strips - 1:
                    edge[r - 1] = (mv[-1], ixn[-1], iy[-1])
                if r <= live:
                    if local:
                        up = mv > cbv
                        cbv = np.where(up, mv, cbv).astype(F32)
                        cbr = np.where(up, r, cbr)
                    mp, xp, yp = mv, ixn, iy
                    eh, eam = xh, xam
            if local:
                for c in range(W):
                    cand = (cbv[c], int(cbr[c]), int(j[c]))
                    if cbv[c] != np.inf and _beats(cand, lane_best[c // cols]):
                        lane_best[c // cols] = cand
            elif j[0] <= lbc <= j[-1]:
                c = lbc - j[0]
                ends = (mp[c], xp[c], yp[c])
                if la > n:
                    ends = tuple(x[()] for x in _row0(lbc, go, ge))
                st = int(np.argmax(ends))
                rec[p, :4] = (ends[st], la, lb, st)
        if local:
            best = lane_best[0]
            for cand in lane_best[1:]:
                if _beats(cand, best):
                    best = cand
            if not best[0] > NEG:
                best = (NEG, 0, 0)
            rec[p, :4] = (best[0], best[1], best[2], M_ST)
    return dirs, rec


def _pallas(A, Bm, lens, sub, go, local):
    return gotoh_forward_pallas(jnp.asarray(A), jnp.asarray(Bm),
                                jnp.asarray(lens), jnp.asarray(sub),
                                gap_open=go, gap_extend=1, local=local,
                                block_rows=16, interpret=True)


def _model_vs_pallas(A, Bm, lens, sub, go, local, **layout):
    dirs, rec = _kernel_model(A, Bm, lens, sub, go, 1, local, **layout)
    ref = _pallas(A, Bm, lens, sub, go, local)
    np.testing.assert_array_equal(np.asarray(ref.dirs), dirs, err_msg="dirs")
    for k, name in enumerate(("score", "start_i", "start_j",
                              "start_state")):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, name)), rec[:, k].astype(
                np.float32 if k == 0 else np.int32), err_msg=name)


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("B,n,m,layout", [
    (5, 23, 37, dict(lanes=4, cols=2)),      # 5 strips, a ragged last one
    (4, 19, 7, dict(lanes=4, cols=2)),       # m + 1 at a strip's edge
    (4, 17, 8, dict(lanes=4, cols=2)),       # one column past it
    (3, 9, 30, dict(lanes=2, cols=1)),       # C = 1: column 1 on lane 1
    (4, 30, 26, dict(lanes=4, cols=3)),      # odd C
])
def test_kernel_order_of_work_matches_pallas(B, n, m, layout, local):
    A, Bm, lens = _case(7 * n + m + local, B, n, m)
    sub = np.asarray(jab.dna_matrix(), np.float32)
    _model_vs_pallas(A, Bm, lens, sub, 3, local, **layout)


@pytest.mark.parametrize("local", [False, True])
def test_kernel_order_of_work_blosum_gap11(local):
    A, Bm, lens = _case(13, 3, 21, 26, n_chars=21)
    sub = np.asarray(jab.blosum62(), np.float32)
    _model_vs_pallas(A, Bm, lens, sub, 11, local)


def test_kernel_order_of_work_local_ties_across_rows_and_strips():
    """A repeated unit in the query (twice, 10 mismatches apart) and in the
    target (6 times): the local maximum 12 ends in rows 6 and 22 at columns
    6, 12, ..., 36, in every strip and several lanes; the first row, then
    the first column must win."""
    unit = np.array([1, 2, 3, 1, 3, 2], np.int8)
    q = np.concatenate([unit, np.zeros(10, np.int8), unit])       # 22
    A = np.tile(q, (3, 1))
    Bm = np.tile(unit, (3, 6))                                    # (3, 36)
    lens = np.array([[22, 36], [22, 11], [5, 36]], np.int32)
    sub = np.asarray(jab.dna_matrix(), np.float32)
    _model_vs_pallas(A, Bm, lens, sub, 3, True)
    _, rec = _kernel_model(A, Bm, lens, sub, 3, 1, True)
    assert tuple(rec[0, :3]) == (12, 6, 6)


# ------------------------------------------------------------ the launch plan

@pytest.mark.parametrize("m", [0, 1, 63, 64, 382, 383, 384, 1486, 1493,
                               16383, 16384, 20000])
def test_sw_plan_covers_every_column_once(m):
    C, strips = ops.strip_layout(m)
    W = 32 * C
    assert 1 <= C <= ops.MAX_COLS
    assert strips == -(-(m + 1) // (32 * ops.MAX_COLS))
    # strips [s W, (s + 1) W) partition the columns; the last one is used
    assert (strips - 1) * W <= m < strips * W
    assert strips * W - (m + 1) < 32 * strips     # < 32 idle columns a strip
    for B in (1, 3, 4, 5, 3735, 100000):
        plan = ops.sw_plan(B, 1493, m, ctas=528)
        assert (plan.cols_per_lane, plan.strips) == (C, strips)
        assert plan.grid == max(1, min(-(-B // ops.PAIRS_PER_CTA), 528))
        assert plan.grid * ops.PAIRS_PER_CTA >= min(B, 528 * 4)
        assert plan.slot_bytes == (ops.EDGE_BYTES * 1493 if strips > 1
                                   else 0)
        assert plan.workspace_bytes == (plan.grid * ops.PAIRS_PER_CTA
                                        * plan.slot_bytes)
        # bounded by the resident slots, whatever B
        assert plan.workspace_bytes <= 528 * ops.PAIRS_PER_CTA * 16 * 1493


def test_sw_plan_matches_the_main_path_layouts():
    assert ops.strip_layout(1493) == (12, 4)
    assert ops.strip_layout(1486) == (12, 4)
    assert ops.strip_layout(64) == (3, 1)
    assert ops.strip_layout(20000) == (12, 53)
    big = ops.sw_plan(10**6, 1493, 20000, ctas=528)
    assert big.workspace_bytes == 528 * 4 * 16 * 1493
