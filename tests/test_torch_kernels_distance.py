"""Port parity: the match/valid kernel wrapper and the distance stage.

On a CPU tensor ``repro_torch.kernels.distance.ops.match_valid`` runs the
kernel's plain version; its counts must equal the reference Pallas kernel
(interpret mode) and ``repro.core.distance.match_valid_counts`` exactly.
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


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros((3, 4), dtype=torch.int8)
    with pytest.raises(TypeError):
        ops.match_valid(a.int(), a, n_chars=5, gap_code=5)
    with pytest.raises(ValueError):
        ops.match_valid(a, a[:, :3], n_chars=5, gap_code=5)
