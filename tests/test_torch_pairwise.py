"""Port parity: repro_torch.core.pairwise against repro.core.pairwise.

Same numpy inputs through both; scores, every direction byte (the full
(n+1, m+1) matrix — the port's plain forward scans like the reference
oracle), traceback starts and aligned rows must be exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alphabet as jab
from repro.core import pairwise as jpw
from repro_torch.core import alphabet as tab
from repro_torch.core import pairwise as tpw


def _case(seed, B, n, m, n_chars):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, n_chars, (B, n)).astype(np.int8)
    Bm = rng.integers(0, n_chars, (B, m)).astype(np.int8)
    la = rng.integers(0, n + 1, B).astype(np.int32)
    lb = rng.integers(0, m + 1, B).astype(np.int32)
    # the edge cases: empty query, empty target, both empty, length 1
    la[0], lb[1] = 0, 0
    la[2], lb[2] = 0, 0
    la[3], lb[3] = 1, 1
    la[4], lb[4] = 1, m
    return A, la, Bm, lb


MATRICES = {
    "dna": (lambda: np.asarray(jab.dna_matrix(), np.float32), 5, 5, 3),
    "blosum62": (lambda: np.asarray(jab.blosum62(), np.float32), 21, 21, 11),
}


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_forward_and_traceback_match_reference(local, matrix):
    make, n_chars, gap, go = MATRICES[matrix]
    sub = make()
    A, la, Bm, lb = _case(7 + local, 7, 23, 31, n_chars)
    tf = tpw.gotoh_forward(torch.from_numpy(A), torch.from_numpy(la),
                           torch.from_numpy(Bm), torch.from_numpy(lb),
                           torch.from_numpy(sub), go, 1, local=local)
    ta, tb, tk = tpw.traceback(torch.from_numpy(A), torch.from_numpy(Bm),
                               tf, gap)
    for i in range(A.shape[0]):
        jf = jpw.gotoh_forward(jnp.asarray(A[i]), jnp.int32(la[i]),
                               jnp.asarray(Bm[i]), jnp.int32(lb[i]),
                               jnp.asarray(sub), go, 1, local=local)
        assert float(jf.score) == float(tf.score[i])
        np.testing.assert_array_equal(np.asarray(jf.dirs), tf.dirs[i].numpy())
        assert (int(jf.start_i), int(jf.start_j), int(jf.start_state)) == (
            int(tf.start_i[i]), int(tf.start_j[i]), int(tf.start_state[i]))
        ja, jb, jk = jpw.traceback(jnp.asarray(A[i]), jnp.asarray(Bm[i]), jf,
                                   gap)
        assert int(jk) == int(tk[i])
        np.testing.assert_array_equal(np.asarray(ja), ta[i].numpy())
        np.testing.assert_array_equal(np.asarray(jb), tb[i].numpy())


@pytest.mark.parametrize("local", [False, True])
def test_align_many_to_one_matches_reference(local):
    A, la, _, _ = _case(3, 6, 40, 1, 4)
    rng = np.random.default_rng(4)
    b = rng.integers(0, 4, 33).astype(np.int8)
    lb = 29
    sub = np.asarray(jab.dna_matrix(), np.float32)
    ref = jpw.align_many_to_one(jnp.asarray(A), jnp.asarray(la),
                                jnp.asarray(b), lb, jnp.asarray(sub),
                                gap_open=3, gap_extend=1, local=local)
    out = tpw.align_many_to_one(torch.from_numpy(A), torch.from_numpy(la),
                                torch.from_numpy(b), lb,
                                torch.from_numpy(sub), gap_open=3,
                                gap_extend=1, local=local)
    for name in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(out, name).numpy(), err_msg=name)


def test_substitution_matrices_equal_reference():
    np.testing.assert_array_equal(tab.dna_matrix(), np.asarray(jab.dna_matrix()))
    np.testing.assert_array_equal(tab.dna_matrix(3, -2),
                                  np.asarray(jab.dna_matrix(3, -2)))
    np.testing.assert_array_equal(tab.blosum62(), np.asarray(jab.blosum62()))
    seqs = ["ACGTNRY", "", "acgu-t"]
    S, lens = tab.encode_batch(seqs, tab.DNA)
    JS, jlens = jab.encode_batch(seqs, jab.DNA)
    np.testing.assert_array_equal(S, np.asarray(JS))
    np.testing.assert_array_equal(lens, np.asarray(jlens))
