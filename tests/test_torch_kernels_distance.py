"""Port parity: the match/valid kernel wrapper and the distance stage.

On a CPU tensor ``repro_torch.kernels.distance.ops.match_valid`` (and
``match_valid_groups``) runs the kernel's plain version; its counts must
equal the reference Pallas kernel (interpret mode) and
``repro.core.distance.match_valid_counts`` exactly, at the shapes and
alphabets of every route the card takes (``ops.route``).
Distances go through ``log``, where XLA and torch may differ by an ulp:
they are compared at rtol=1e-6, atol=1e-7. The SP score sums N^2 float32
entries in another order: rtol=1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distance as jdist
from repro.core import sp_score as jsp
from repro.kernels.distance.ops import match_valid_pallas
from repro_torch.core import distance as tdist
from repro_torch.core import sp_score as tsp
from repro_torch.kernels.distance import ops


def _rows(seed, N, L, lo=0, hi=6):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (N, L)).astype(np.int8)


@pytest.mark.parametrize("N,M,L,lo", [(40, 40, 130, 0), (37, 21, 33, 0),
                                      (16, 9, 70, -2)])
def test_match_valid_exact(N, M, L, lo):
    a, b = _rows(N, N, L, lo), _rows(M + 1, M, L, lo)
    pm, pv = match_valid_pallas(jnp.asarray(a), jnp.asarray(b), n_chars=5,
                                gap_code=5, bn=16, bl=32, interpret=True)
    jm, jv = jdist.match_valid_counts(jnp.asarray(a), jnp.asarray(b),
                                      gap_code=5, n_chars=5)
    tm, tv = ops.match_valid(torch.from_numpy(a), torch.from_numpy(b),
                             n_chars=5, gap_code=5)
    assert tm.dtype == torch.int32 and tv.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(pm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(pv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("correct", [True, False])
def test_distance_matrix_matches_reference(correct):
    msa = _rows(3, 30, 90)
    msa[:, :10] = 5                          # shared gap block
    msa[0, 10:] = 5                          # a row with no overlap at all
    ref = jdist.distance_matrix(jnp.asarray(msa), gap_code=5, n_chars=5,
                                correct=correct)
    out = tdist.distance_matrix(torch.from_numpy(msa), gap_code=5, n_chars=5,
                                correct=correct)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_sp_score_matches_reference():
    msa = _rows(8, 25, 77)
    ref = float(jsp.avg_sp(jnp.asarray(msa), gap_code=5, n_chars=5))
    out = float(tsp.avg_sp(torch.from_numpy(msa), gap_code=5, n_chars=5))
    np.testing.assert_allclose(out, ref, rtol=1e-5)


# (N, M, L, n_chars, gap, codes lo..hi-1, symmetric): the card's skinny
# route (M = 1, N = 1, a symmetric call of 7 rows), its tensor-core route
# (protein with codes below 0 and above n_chars other than the gap, the gap
# inside the alphabet, L not a multiple of 32, symmetric) and its SIMD route
# (n_chars above the tensor-core maximum)
ROUTE_CASES = [
    (23, 1, 70, 5, 5, 0, 6, False),
    (1, 19, 45, 5, 5, -1, 7, False),
    (7, 7, 33, 5, 5, 0, 6, True),
    (30, 17, 61, 21, 21, -3, 25, False),
    (26, 26, 100, 21, 21, -2, 24, True),
    (20, 12, 40, 6, 2, 0, 8, False),
    (18, 18, 77, 40, 40, -2, 44, True),
]


@pytest.mark.parametrize("N,M,L,n_chars,gap,lo,hi,sym", ROUTE_CASES)
def test_match_valid_routes_exact(N, M, L, n_chars, gap, lo, hi, sym):
    a, b = _rows(N, N, L, lo, hi), _rows(M + 7, M, L, lo, hi)
    if sym:
        b = a
    pm, pv = match_valid_pallas(jnp.asarray(a), jnp.asarray(b),
                                n_chars=n_chars, gap_code=gap, bn=16, bl=32,
                                interpret=True)
    tm, tv = ops.match_valid(torch.from_numpy(a),
                             None if sym else torch.from_numpy(b),
                             n_chars=n_chars, gap_code=gap)
    np.testing.assert_array_equal(np.asarray(pm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(pv), tv.numpy())
    expect = ("skinny" if min(N, M) <= ops.SKINNY_MAX else
              "tc" if n_chars <= ops.TC_MAX_CHARS else "simd")
    assert ops.route(N, M, n_chars) == expect


def test_symmetric_call_equals_asymmetric():
    a = torch.from_numpy(_rows(9, 33, 70, -1, 7))
    sm, sv = ops.match_valid(a, None, n_chars=5, gap_code=5)
    am, av = ops.match_valid(a, a, n_chars=5, gap_code=5)
    assert torch.equal(sm, am) and torch.equal(sv, av)
    assert torch.equal(sm, sm.T) and torch.equal(sv, sv.T)


def _groups(rows, sizes, width, seed):
    rng = np.random.default_rng(seed)
    return [rng.choice(rows, size=s, replace=False) for s in sizes], width


@pytest.mark.parametrize("sizes,width,n_chars,gap,lo,hi", [
    ((5, 0, 1, 12, 3), 12, 5, 5, 0, 6),     # ragged, empty, one row
    ((9, 20, 2), 24, 21, 21, -2, 24),       # protein, padded past the max
    ((), 10, 5, 5, 0, 6),                   # an empty chunk
    ((4, 6), 6, 40, 40, 0, 42),             # the SIMD route's alphabet
])
def test_match_valid_groups_exact(sizes, width, n_chars, gap, lo, hi):
    msa = _rows(11, 40, 75, lo, hi)
    groups, width = _groups(40, sizes, width, 12)
    index = tdist.group_index(groups, width, "cpu")
    assert index.shape == (len(sizes), width) and index.dtype == torch.int64
    tm, tv = ops.match_valid_groups(torch.from_numpy(msa), index,
                                    n_chars=n_chars, gap_code=gap)
    assert tm.shape == tv.shape == (len(sizes), width, width)
    assert tm.dtype == tv.dtype == torch.int32
    for g, rows in enumerate(groups):
        n = len(rows)
        if n:
            sub = jnp.asarray(msa[rows])
            pm, pv = match_valid_pallas(sub, sub, n_chars=n_chars,
                                        gap_code=gap, bn=16, bl=32,
                                        interpret=True)
            np.testing.assert_array_equal(np.asarray(pm), tm[g, :n, :n])
            np.testing.assert_array_equal(np.asarray(pv), tv[g, :n, :n])
        # a pad row counts nothing
        assert not tm[g, n:].any() and not tm[g, :, n:].any()
        assert not tv[g, n:].any() and not tv[g, :, n:].any()


@pytest.mark.parametrize("correct", [True, False])
def test_distance_groups_match_reference(correct):
    msa = _rows(13, 50, 90)
    msa[:, :10] = 5                          # shared gap block
    msa[3, 10:] = 5                          # a row with no overlap at all
    groups, width = _groups(50, (7, 1, 0, 16, 3), 16, 14)
    groups[0][0] = 3
    out = tdist.distance_groups(torch.from_numpy(msa),
                                tdist.group_index(groups, width, "cpu"),
                                gap_code=5, n_chars=5, correct=correct)
    assert out.shape == (5, 16, 16) and out.dtype == torch.float32
    for g, rows in enumerate(groups):
        n = len(rows)
        if n:
            ref = jdist.distance_matrix(jnp.asarray(msa[rows]), gap_code=5,
                                        n_chars=5, correct=correct)
            np.testing.assert_allclose(out[g, :n, :n].numpy(),
                                       np.asarray(ref), rtol=1e-6, atol=1e-7)
            # each entry the float the port's per-group call gives
            own = tdist.distance_matrix(torch.from_numpy(msa[rows]),
                                        gap_code=5, n_chars=5,
                                        correct=correct)
            assert torch.equal(out[g, :n, :n], own)
        assert not out[g, n:].any() and not out[g, :, n:].any()


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros((3, 4), dtype=torch.int8)
    with pytest.raises(TypeError):
        ops.match_valid(a.int(), a, n_chars=5, gap_code=5)
    with pytest.raises(ValueError):
        ops.match_valid(a, a[:, :3], n_chars=5, gap_code=5)
    msa = torch.zeros((5, 4), dtype=torch.int8)
    with pytest.raises(TypeError):
        ops.match_valid_groups(msa, torch.zeros((2, 3), dtype=torch.int32),
                               n_chars=5, gap_code=5)
    with pytest.raises(ValueError):
        ops.match_valid_groups(msa, torch.full((2, 3), 5), n_chars=5,
                               gap_code=5)
    with pytest.raises(ValueError):
        ops.match_valid_groups(msa, torch.full((2, 3), -2), n_chars=5,
                               gap_code=5)
