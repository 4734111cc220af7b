"""Port parity: site patterns, the pruning likelihood, the model registry
and the ML refiner's pieces.

The same numpy inputs go through ``repro.core.likelihood`` /
``repro.phylo.{models,ml}`` and their ``repro_torch`` counterparts (on the
CPU). Tolerances: patterns, candidates, renumbering, weighted counts and
supports (given the reference's bootstrap weights) exact; logL at
rtol=1e-5 under all four models, with a shuffled valid ``order`` and with
site chunks; its gradient within 1e-3 of the largest component; P(t)
(not U: eigenvector signs differ) at atol=3e-6; refined logL within
1e-4 * |logL| of the reference's and not below it by more than that, the
same selected model and ``n_nni``, RF 0 unrooted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alphabet as jab
from repro.core import distance as jdist
from repro.core import likelihood as jlik
from repro.core import nj as jnj
from repro.core import treeio as jtreeio
from repro.data import SimConfig, simulate_family
from repro.phylo import ml as jml
from repro.phylo import models as jmodels
from repro_torch.core import likelihood as tlik
from repro_torch.phylo import ml as tml
from repro_torch.phylo import models as tmodels
from test_torch_msa_run import one_torch_thread  # noqa: F401

GAP, NCH = jab.DNA.gap_code, jab.DNA.n_chars
N = 10


def _family(seed, n=N, L=160, sub=0.08):
    fam = simulate_family(SimConfig(n_leaves=n, root_len=L, seed=seed,
                                    branch_sub=sub, branch_indel=0.0))
    msa = np.array(jab.encode_batch(fam.seqs, jab.DNA)[0])
    msa[2, 5:9] = GAP                      # some gap columns
    D = jdist.distance_matrix(jnp.asarray(msa), gap_code=GAP, n_chars=NCH)
    ch, bl, rt = jnj.host_tree(jnj.neighbor_joining(D, n))
    return msa, ch, np.maximum(bl, 0.0).astype(np.float32), rt


@pytest.fixture(scope="module")
def fam():
    """10 leaves; seed 1's NJ tree takes one NNI under the refiner."""
    msa, ch, bl, rt = _family(1)
    pat, w = jlik.compress_patterns(msa)
    return msa, ch, bl, rt, pat, w


def _params(model, rng):
    p = jmodels.init_params(model, np.array([0.15, 0.2, 0.3, 0.35],
                                            np.float32))
    return (p + rng.normal(0, 0.7, p.shape)).astype(np.float32)


def _shuffled_order(ch, n, rng):
    """A random topological order of the internal nodes (not by id)."""
    M = ch.shape[0]
    done = set(range(n))
    todo, order = set(range(n, M)), []
    while todo:
        ready = sorted(v for v in todo if set(ch[v]) <= done)
        v = int(rng.choice(ready))
        order.append(v)
        done.add(v)
        todo.remove(v)
    return np.asarray(order, np.int32)


def test_compress_patterns_exact(fam):
    msa, *_ = fam
    for a, b in zip(jlik.compress_patterns(msa),
                    tlik.compress_patterns(torch.from_numpy(msa))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", tmodels.MODELS)
def test_transition_matrices_match(model):
    rng = np.random.default_rng(3)
    for _ in range(4):
        p = _params(model, rng)
        dj = jmodels.decompose(model, p)
        dt = tmodels.decompose(model, torch.from_numpy(p))
        np.testing.assert_allclose(dt.pi.numpy(), np.asarray(dj.pi), rtol=1e-6)
        t = np.array([0.0, 0.01, 0.3, 2.5, -0.1], np.float32)
        Pj = np.stack([np.asarray(jlik._transition_from_decomp(
            dj.lam, dj.U, dj.sp, x)) for x in t])
        Pt = tlik._transition_from_decomp(dt.lam, dt.U, dt.sp,
                                          torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(Pt, Pj, atol=3e-6)
        np.testing.assert_allclose(np.sort(dt.lam.numpy()),
                                   np.sort(np.asarray(dj.lam)), atol=1e-5)


@pytest.mark.parametrize("model", tmodels.MODELS)
@pytest.mark.parametrize("site_chunk", [0, 16])
def test_pruning_loglik_and_gradient(fam, model, site_chunk):
    msa, ch, bl, rt, pat, w = fam
    rng = np.random.default_rng(7)
    order = _shuffled_order(ch, N, rng)
    assert not np.array_equal(order, np.arange(N, 2 * N - 1))
    p = _params(model, rng)
    bl = bl + rng.random(bl.shape).astype(np.float32) * 0.05

    def jfun(b):
        d = jmodels.decompose(model, p)
        return jlik.pruning_log_likelihood(
            jnp.asarray(pat), jnp.asarray(w), jnp.asarray(ch), b,
            jnp.asarray(order), rt, d.lam, d.U, d.sp, d.pi,
            site_chunk=site_chunk)

    ref, gref = jax.value_and_grad(jfun)(jnp.asarray(bl))
    d = tmodels.decompose(model, torch.from_numpy(p))
    blt = torch.from_numpy(bl).requires_grad_(True)
    out = tlik.pruning_log_likelihood(
        torch.from_numpy(pat), torch.from_numpy(w), ch, blt, order, rt,
        d.lam, d.U, d.sp, d.pi, site_chunk=site_chunk)
    out.backward()
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)
    gref = np.asarray(gref)
    assert np.abs(blt.grad.numpy() - gref).max() <= 1e-3 * np.abs(gref).max()


def test_forest_equals_trees_and_runs_by_height(fam):
    """A stack of NNI candidates scores as one forest exactly as each
    tree alone; the schedule has one step per height, not per node."""
    msa, ch, bl, rt, pat, w = fam
    order = np.arange(N, 2 * N - 1)
    # no zero-length branch: across one between differing tips a site
    # keeps only P(0)'s rounding residue (~1e-8) and partials near the
    # 1e-30 floor, where the two packages' products round apart
    # (ROADMAP.md §3); the refiner scores fitted, softplus-positive lengths
    ch_k, bl_k, od_k = tml.nni_candidates(ch, bl + 1e-3, order, N)
    d = tmodels.decompose("k80", torch.tensor([0.4]))
    pt, wt = torch.from_numpy(pat), torch.from_numpy(w)
    sched = tlik.level_schedule(ch_k, od_k, rt, N, "cpu")
    height = max(len(tlik.level_schedule(c, o, rt, N, "cpu").levels)
                 for c, o in zip(ch_k, od_k))
    assert len(sched.levels) == height < N - 1
    forest = tlik.forest_log_likelihood(pt, wt, sched, torch.from_numpy(bl_k),
                                        d.lam, d.U, d.sp, d.pi).numpy()
    alone = [float(tlik.pruning_log_likelihood(pt, wt, c, torch.from_numpy(b),
                                               o, rt, d.lam, d.U, d.sp, d.pi))
             for c, b, o in zip(ch_k, bl_k, od_k)]
    np.testing.assert_allclose(forest, alone, rtol=1e-6)
    # budget of one tree per chunk: the same scores
    one = tml._score_candidates(pt, wt, ch_k, bl_k, od_k, rt,
                                np.array([0.4], np.float32), model="k80",
                                site_chunk=0, budget=1)
    np.testing.assert_allclose(one, forest, rtol=1e-6)
    ref = np.asarray(jml._score_candidates(
        jnp.asarray(pat), jnp.asarray(w), jnp.asarray(ch_k),
        jnp.asarray(bl_k), jnp.asarray(od_k), rt,
        jnp.asarray([0.4], jnp.float32), model="k80", site_chunk=0))
    np.testing.assert_allclose(forest, ref, rtol=1e-5)


@pytest.mark.parametrize("model", ["hky85", "gtr"])
def test_jacobi_decomposition_over_many_draws(model):
    """HKY85/GTR's fixed-sweep Jacobi at 100 draws: skewed pi (0.4/0.1/
    0.1/0.4 and sharper) and kappa or GTR rates across e^-3..e^3. P(t) is
    held at atol 1e-6 against expm of the same Q in float64, and at 5e-6
    against JAX (whose float32 eigh is itself up to 3.6e-6 from expm on
    these draws); U^T S U is diagonal to 1e-6."""
    from scipy.linalg import expm
    rng = np.random.default_rng(11)
    skews = [None, [0.4, 0.1, 0.1, 0.4], [0.7, 0.1, 0.1, 0.1],
             [0.05, 0.45, 0.45, 0.05]]
    t = np.array([0.0, 0.01, 0.3, 2.5], np.float32)
    n_rates = 5 if model == "gtr" else 1
    for i in range(100):
        f = skews[i % 4]
        p = jmodels.init_params(
            model, None if f is None else np.array(f, np.float32)).copy()
        p[:n_rates] = (rng.choice([-3.0, 3.0], n_rates) if i < 8
                       else rng.uniform(-3, 3, n_rates))
        if f is None:
            p[-3:] += rng.normal(0, 1, 3)
        p = p.astype(np.float32)
        dt = tmodels.decompose(model, torch.from_numpy(p))
        Pt = tlik._transition_from_decomp(dt.lam, dt.U, dt.sp,
                                          torch.from_numpy(t)).numpy()
        Q, pi = tmodels.rate_matrix(model, torch.from_numpy(p))
        Q = Q.double().numpy()
        np.testing.assert_allclose(
            Pt, np.stack([expm(Q * float(x)) for x in t]), atol=1e-6)
        dj = jmodels.decompose(model, p)
        Pj = np.stack([np.asarray(jlik._transition_from_decomp(
            dj.lam, dj.U, dj.sp, x)) for x in t])
        np.testing.assert_allclose(Pt, Pj, atol=5e-6)
        sp = np.sqrt(pi.double().numpy())
        S = sp[:, None] * Q / sp[None, :]
        U = dt.U.double().numpy()
        A = U.T @ (0.5 * (S + S.T)) @ U
        assert np.abs(A - np.diag(np.diag(A))).max() <= 1e-6


def test_model_registry_host_pieces(fam):
    _, _, _, _, pat, w = fam
    np.testing.assert_array_equal(tmodels.empirical_freqs(pat, w),
                                  jmodels.empirical_freqs(pat, w))
    for m in tmodels.MODELS:
        np.testing.assert_array_equal(tmodels.init_params(m),
                                      jmodels.init_params(m))
        assert tmodels.bic(-123.5, m, 18, 160.0) == \
            jmodels.bic(-123.5, m, 18, 160.0)
    with pytest.raises(ValueError, match="unknown substitution model"):
        tmodels.validate("f81")


def test_fit_matches_reference(fam):
    msa, ch, bl, rt, pat, w = fam
    order = np.arange(N, 2 * N - 1)
    kw = dict(model="hky85", steps=25, lr=0.05, site_chunk=0)
    p0 = jmodels.init_params("hky85", jmodels.empirical_freqs(pat, w))
    bj, pj, lj = jml._fit(jnp.asarray(pat), jnp.asarray(w), jnp.asarray(ch),
                          jnp.asarray(order), rt, jnp.asarray(bl), p0, **kw)
    bt, pt_, lt = tml._fit(torch.from_numpy(pat), torch.from_numpy(w), ch,
                           order, rt, bl, p0, **kw)
    lj, lt = float(lj), float(lt)
    assert abs(lt - lj) <= 1e-4 * abs(lj)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=2e-3,
                               atol=2e-4)


def test_nni_candidates_and_renumbering_exact(fam):
    _, ch, bl, rt, *_ = fam
    order = _shuffled_order(ch, N, np.random.default_rng(2))
    a = jml.nni_candidates(ch, bl, order, N)
    b = tml.nni_candidates(ch, bl, order, N)
    assert a[0].shape[0] == 2 * (N - 2)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for k in (0, 5, 11):
        ra = jml.renumber_topological(a[0][k], a[1][k], rt, a[2][k], N)
        rb = tml.renumber_topological(b[0][k], b[1][k], rt, b[2][k], N)
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x, y)


def test_replicate_weights_sum_and_chunking(fam):
    _, _, _, _, pat, w = fam
    n_sites = int(w.sum())
    W = tml.replicate_weights(5, w, n_replicates=9, n_sites=n_sites)
    assert W.shape == (9, len(w)) and W.dtype == torch.float32
    np.testing.assert_array_equal(W.sum(1).numpy(), np.full(9, n_sites))
    parts = torch.cat([tml.replicate_weights(5, w, n_replicates=4,
                                             n_sites=n_sites),
                       tml.replicate_weights(5, w, n_replicates=5,
                                             n_sites=n_sites, start=4)])
    assert torch.equal(W, parts)
    assert not torch.equal(W, tml.replicate_weights(6, w, n_replicates=9,
                                                    n_sites=n_sites))
    assert not torch.equal(W[0], W[1])


def test_weighted_counts_and_supports_given_reference_weights(fam):
    msa, ch, bl, rt, pat, w = fam
    Wj = np.asarray(jml.replicate_weights(jax.random.PRNGKey(3),
                                          jnp.asarray(w), n_replicates=12,
                                          n_sites=int(w.sum())))
    pt = torch.from_numpy(pat)
    Dt = tml.weighted_distance_matrix(pt, torch.from_numpy(Wj),
                                      gap_code=GAP, n_chars=NCH)
    for b in (0, 7):
        Dj = np.asarray(jml.weighted_distance_matrix(
            jnp.asarray(pat), jnp.asarray(Wj[b]), gap_code=GAP, n_chars=NCH))
        np.testing.assert_allclose(Dt[b].numpy(), Dj, rtol=1e-6, atol=1e-7)
        one = tml.weighted_distance_matrix(pt, torch.from_numpy(Wj[b]),
                                           gap_code=GAP, n_chars=NCH)
        assert torch.equal(one, Dt[b])
    # unit weights: the dense distance matrix
    np.testing.assert_allclose(
        tml.weighted_distance_matrix(torch.from_numpy(msa),
                                     torch.ones(msa.shape[1]),
                                     gap_code=GAP, n_chars=NCH).numpy(),
        np.asarray(jdist.distance_matrix(jnp.asarray(msa), gap_code=GAP,
                                         n_chars=NCH)), rtol=1e-6, atol=1e-7)
    ch_j, _ = jml.replicate_trees(jnp.asarray(pat), jnp.asarray(Wj),
                                  gap_code=GAP, n_chars=NCH)
    ch_t, _ = tml.replicate_trees(pt, Wj, gap_code=GAP, n_chars=NCH,
                                  budget=1)
    for b in range(12):
        assert jtreeio.bipartitions(np.asarray(ch_j[b]), 2 * N - 2, N) == \
            jtreeio.bipartitions(ch_t[b], 2 * N - 2, N)
    sj = jml.split_support(ch, rt, N, np.asarray(ch_j))
    st = tml.split_support(ch, rt, N, ch_t)
    np.testing.assert_array_equal(st, sj)
    assert np.isfinite(st).sum() == N - 3


@pytest.fixture(scope="module")
def refined(fam):
    msa, ch, bl, rt, *_ = fam
    kw = dict(gap_code=GAP, steps=25, nni_rounds=4)
    return (jml.MLRefiner(**kw).refine(msa, ch, bl, rt),
            tml.MLRefiner(device="cpu", **kw).refine(msa, ch, bl, rt))


def test_refine_matches_reference(refined):
    ref, out = refined
    assert out.model == ref.model
    assert out.n_nni == ref.n_nni == 1
    assert set(out.bic) == set(ref.bic) == set(tmodels.MODELS)
    np.testing.assert_allclose(out.logl_init, ref.logl_init, rtol=1e-5)
    tol = 1e-4 * abs(ref.logl_final)
    assert abs(out.logl_final - ref.logl_final) <= tol
    assert out.logl_final >= ref.logl_final - tol
    assert out.logl_final > out.logl_init
    assert jtreeio.bipartitions(out.children, out.root, N) == \
        jtreeio.bipartitions(ref.children, ref.root, N)
    # index-topological again
    for v in range(N, 2 * N - 1):
        assert (out.children[v] < v).all()


def test_refiner_refuses_a_mesh_and_defaults_to_the_card(monkeypatch):
    """A mesh is ported: in a world of one the refined tree and the
    bootstrap support are the refiner's without one. Without a card the
    default device raises."""
    from repro_torch.launch import mesh as lm
    msa, ch, bl, rt = _family(0, n=5, L=40)
    kw = dict(gap_code=GAP, model="jc69", steps=5, nni_rounds=1,
              device="cpu")
    one = tml.MLRefiner(**kw)
    with lm.world("cpu"):
        ref = tml.MLRefiner(mesh=lm.mesh_from_arg(None, device="cpu"), **kw)
        got = ref.refine(msa, ch, bl, rt)
        sup = ref.bootstrap(msa, got.children, got.blen, got.root, 6)
    want = one.refine(msa, ch, bl, rt)
    assert got.children.tobytes() == want.children.tobytes()
    assert got.blen.tobytes() == want.blen.tobytes()
    np.testing.assert_array_equal(sup, one.bootstrap(
        msa, want.children, want.blen, want.root, 6))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tml.MLRefiner(gap_code=GAP).refine(msa, ch, bl, rt)


def _peak_bytes(fn):
    """Peak bytes the CPU allocator held during ``fn()`` above its level
    at the first allocation, from the profiler's memory events."""
    import json
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    mem = [e["args"] for e in events if e.get("name") == "[memory]"]
    assert mem
    total = [a["Total Allocated"] for a in mem]
    return max(total) - (total[0] - mem[0]["Bytes"])


@pytest.mark.parametrize("site_chunk,trees", [(0, 4), (64, 3)])
def test_scoring_and_bootstrap_stay_within_their_budget(site_chunk, trees):
    """Candidate scoring and bootstrap batches, each under a budget that
    makes several chunks, allocate no more than ``scoring_bytes`` /
    ``replicate_bytes`` count — the bytes the budget is held to."""
    msa, ch, bl, rt = _family(2, n=40, L=900, sub=0.1)
    n = msa.shape[0]
    pat, w = tlik.compress_patterns(msa)
    P = pat.shape[1]
    pt, wt = torch.from_numpy(pat), torch.from_numpy(w)
    ch_k, bl_k, od_k = tml.nni_candidates(ch, bl, np.arange(n, 2 * n - 1),
                                          n)
    M = ch.shape[0]
    sites = P if site_chunk == 0 else site_chunk
    budget = tml.scoring_bytes(n, M, sites, trees, P)
    if site_chunk:
        assert tml.scoring_plan(n, M, P, site_chunk, budget) == \
            (trees, site_chunk)
    dec = tmodels.decompose("gtr", torch.from_numpy(
        tmodels.init_params("gtr")))
    peak = _peak_bytes(lambda: tml.score_trees(
        pt, wt, ch_k, bl_k, od_k, rt, dec, site_chunk=site_chunk,
        budget=budget))
    assert 0 < peak <= budget
    W = tml.replicate_weights(0, w, n_replicates=3 * trees,
                              n_sites=int(w.sum()))
    budget = tml.replicate_bytes(n, P, NCH, trees)
    assert tml.replicates_per_chunk(n, P, NCH, budget) == trees
    peak = _peak_bytes(lambda: tml.replicate_trees(
        pt, W, gap_code=GAP, n_chars=NCH, budget=budget))
    assert 0 < peak <= budget
