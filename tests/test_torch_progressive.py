"""Port parity: the progressive MSA baseline against the JAX package.

``repro_torch.core.progressive`` on the CPU against ``repro.core.
progressive`` on the same numpy inputs: the k-mer sketches, the UPGMA
merges, the profile DP's directions and score, and the final rows on the
paper's Table 2-4 fixtures (the diverged DNA family of
``tests/test_msa.py`` and the protein family of ``benchmarks/bench_msa.py::
table4_protein_msa``), byte for byte.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alphabet as jab
from repro.core import progressive as jprog
from repro.core.msa import MSAConfig as JConfig
from repro.data import SimConfig, simulate_family
from repro_torch.core import alphabet as ab
from repro_torch.core import progressive as prog
from repro_torch.core.msa import MSAConfig, center_star_msa
from repro_torch.core.sp_score import avg_sp


def _dna_family():
    """``tests/test_msa.py::test_progressive_baseline_valid_and_better_on_
    diverged``'s family: 8 diverged sequences of ~250."""
    return simulate_family(SimConfig(n_leaves=8, root_len=250,
                                     branch_sub=0.06, branch_indel=0.004,
                                     seed=5)).seqs


def _protein_family():
    """``bench_msa.py::table4_protein_msa``'s family: 16 proteins of ~459."""
    return simulate_family(SimConfig(n_leaves=16, root_len=459,
                                     alphabet="protein", branch_sub=0.05,
                                     branch_indel=0.002, seed=3)).seqs


FIXTURES = {
    "dna": (_dna_family, dict(method="plain")),
    "protein": (_protein_family, dict(method="plain", alphabet="protein",
                                      gap_open=8)),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_kmer_sketch_within_1e6(name):
    seqs_fn, kw = FIXTURES[name]
    seqs = seqs_fn()
    alpha = MSAConfig(**kw).alpha()
    S, lens = ab.encode_batch(seqs, alpha)
    k = 3 if alpha.n_chars > 5 else 4
    mine = prog.kmer_sketch(torch.from_numpy(S), torch.from_numpy(lens),
                            n_chars=alpha.n_chars, k=k).numpy()
    ref = np.asarray(jprog.kmer_sketch(jnp.asarray(S), jnp.asarray(lens),
                                       n_chars=alpha.n_chars, k=k))
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-6)
    # the histogram counts are exact: equal supports
    np.testing.assert_array_equal(mine > 0, ref > 0)


def test_upgma_merges_equal():
    rng = np.random.default_rng(4)
    for N in (2, 7, 30):
        X = rng.random((N, 5))
        D = ((X[:, None] - X[None]) ** 2).sum(-1).astype(np.float32)
        assert prog.upgma(D) == jprog.upgma(D)


def _profiles(rng, La, Lb, C, mixed):
    def one(L, n):
        rows = rng.integers(0, C + 1, (n, L))          # C: a gap
        oh = (rows[:, :, None] == np.arange(C)).astype(np.float32)
        return oh.mean(axis=0)
    return (one(La, 3 if mixed else 1), one(Lb, 5 if mixed else 1))


def _candidates(H, S, g, i, j):
    """The port's three candidates of cell (i, j): diagonal, up, left."""
    NEG = prog.NEG
    diag = H[i - 1, j - 1] + S[i - 1, j - 1] if j > 0 else NEG
    left = max(H[i, k] - (j - k) * g for k in range(j)) if j > 0 else NEG
    return np.array([diag, H[i - 1, j] - g, left], np.float64)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("alphabet", ["dna", "protein"])
def test_profile_align_dirs_equal(mixed, alphabet):
    """On one-hot profiles (integer column scores) directions and score are
    equal. On mixed profiles the column scores are sums of products of
    fractions, which torch's matmul and XLA's sum in different orders (no
    order of plain float32 operations gives XLA's bits): given XLA's own
    column scores the DP is bit-exact, the port's column scores are within
    1e-6 of them, and a direction of the port's may differ only at a tie
    that rounding splits — there the reference's choice is within 1e-5 of
    the cell's value in the port's own rows too (shown cell by cell)."""
    rng = np.random.default_rng(7 + mixed)
    cfg = MSAConfig(alphabet=alphabet)
    C = cfg.alpha().n_chars
    sub = cfg.matrix("cpu")[:C, :C]
    g = 3.0
    for La, Lb in ((1, 1), (30, 45), (120, 97)):
        pa, pb = _profiles(rng, La, Lb, C, mixed)
        tpa, tpb = torch.from_numpy(pa), torch.from_numpy(pb)
        dirs, score = prog.profile_align_dirs(tpa, tpb, sub, gap_pen=g)
        jpa, jpb = jnp.asarray(pa), jnp.asarray(pb)
        jsub = jnp.asarray(sub.numpy())
        jd, js = jprog.profile_align_dirs(jpa, jpb, jsub, gap_pen=g)
        jd = np.asarray(jd)
        if not mixed:
            np.testing.assert_array_equal(dirs.numpy(), jd)
            assert float(score) == float(js)
            continue
        S_ref = torch.from_numpy(np.array(jpa @ jsub @ jpb.T))
        H_ref = prog.nw_rows(S_ref, g)
        np.testing.assert_array_equal(prog.nw_dirs(H_ref, S_ref, g).numpy(),
                                      jd)
        assert float(H_ref[-1, -1]) == float(js)
        S = (tpa @ sub) @ tpb.T
        np.testing.assert_allclose(S.numpy(), S_ref.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(float(score), float(js), rtol=2e-6)
        H = prog.nw_rows(S, g).numpy().astype(np.float64)
        Sn = S.numpy().astype(np.float64)
        flips = np.argwhere(dirs.numpy() != jd)
        assert len(flips) <= jd.size // 1000
        for i, j in flips:
            cand = _candidates(H, Sn, g, i, j)
            assert abs(cand[jd[i, j]] - H[i, j]) <= 1e-5 * max(1.0,
                                                               abs(H[i, j]))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_progressive_msa_rows_equal_reference(name):
    seqs_fn, kw = FIXTURES[name]
    seqs = seqs_fn()
    res = prog.progressive_msa(seqs, MSAConfig(**kw), device="cpu")
    ref = jprog.progressive_msa(seqs, JConfig(**kw))
    np.testing.assert_array_equal(res.msa, np.asarray(ref.msa))
    assert (res.center_idx, res.n_fallback, res.width) == \
        (ref.center_idx, ref.n_fallback, ref.width)
    alpha = MSAConfig(**kw).alpha()
    for s, row in zip(seqs, res.msa):
        assert alpha.decode(row).replace("-", "") == s


def test_progressive_beats_center_star_on_diverged():
    """The paper's Table 2-4 relation on the diverged DNA family, with the
    port's own center star and SP score (lower penalty is better)."""
    seqs = _dna_family()
    cfg = MSAConfig(method="plain")
    gap, nch = ab.DNA.gap_code, ab.DNA.n_chars
    sp_prog = float(avg_sp(torch.from_numpy(
        prog.progressive_msa(seqs, cfg, device="cpu").msa),
        gap_code=gap, n_chars=nch))
    sp_cs = float(avg_sp(torch.from_numpy(
        center_star_msa(seqs, cfg, device="cpu").msa),
        gap_code=gap, n_chars=nch))
    assert sp_prog <= sp_cs * 1.02


def test_progressive_defaults_to_the_card_and_takes_one_sequence():
    seqs = ["ACGTAC"]
    res = prog.progressive_msa(seqs, MSAConfig(), device="cpu")
    assert res.width == 6 and res.msa.shape == (1, 6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            prog.progressive_msa(["ACGT", "ACGA"], MSAConfig())
    assert jab.DNA.gap_code == ab.DNA.gap_code
