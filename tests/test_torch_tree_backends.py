"""Port parity: the HPTree tree backends against ``repro.phylo``/``core.cluster``.

The same numpy inputs go through the reference and the port (on the CPU).
Exact where the reference is exact: match/valid counts, the medoid picks,
the assignments, the tile accountant's bytes, and within the port the
tiled pipeline against the dense cluster path (bit for bit). Distances
agree at rtol=1e-6 (torch's and XLA's ``log`` differ in the last bit).

Trees: NJ leaves the place of its root to rounding — among the last four
nodes two joins always tie exactly, and all three among the last three —
so the reference and the port may root a tree on different edges. A
single NJ tree is compared unrooted (RF 0, the length behind each split at
rtol=1e-5, atol=1e-6, as ``tests/test_torch_tree.py``). The HPTree
stitch hangs each cluster's subtree by its root, so there the comparison
is: every cluster's own subtree (the tree restricted to its members) at
RF 0, unrooted, with its lengths; the tree over the clusters (the splits
made of whole clusters) at RF 0 with its lengths; and every cluster that
both packages rooted on the same edge with all of its rooted lengths.
Only the edge a cluster hangs from may differ, and the tests bound how
many clusters it differs for.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alphabet as jab
from repro.core import cluster as jcluster
from repro.core import distance as jdist
from repro.core import likelihood as jlik
from repro.core import nj as jnj
from repro.core import treeio as jtreeio
from repro.data import SimConfig, simulate_family
from repro.phylo import TileAccountant as JTileAccountant
from repro.phylo import TileContext as JTileContext
from repro.phylo import TreeEngine as JTreeEngine
from repro.phylo import resolve_tree_backend as jresolve
from repro.phylo import tiled_phylogeny as jtiled
from repro_torch.core import cluster as tcluster
from repro_torch.core import distance as tdist
from repro_torch.core import likelihood as tlik
from repro_torch.core import nj as tnj
from repro_torch.core import treeio as ttreeio
from repro_torch.phylo import (TileAccountant, TileContext, TreeEngine,
                               resolve_tree_backend, tiled_phylogeny)

GAP, NCH = jab.DNA.gap_code, jab.DNA.n_chars
RTOL, ATOL = 1e-5, 1e-6


def _rand_msa(n, L, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, GAP + 1, (n, L)).astype(np.int8)  # incl. gaps


def _aligned_family(n, L=200, sub=0.03, seed=0):
    """Substitution-only family: equal-length rows == already aligned."""
    fam = simulate_family(SimConfig(n_leaves=n, root_len=L, branch_sub=sub,
                                    branch_indel=0.0, seed=seed))
    return np.asarray(jab.encode_batch(fam.seqs, jab.DNA)[0])


def _ctx(**kw):
    return TileContext(gap_code=GAP, n_chars=NCH, device="cpu", **kw)


def _jctx(**kw):
    return JTileContext(gap_code=GAP, n_chars=NCH, **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ tree helpers


def clades(children, blen, root):
    """{leaf set below an edge: the edge's length} of a rooted tree."""
    children, blen = np.asarray(children), np.asarray(blen)
    sets = jtreeio.leaf_sets(children, int(root), 0)
    out = {}
    for node in sets:
        if children[node, 0] >= 0:
            for side in (0, 1):
                out[sets[int(children[node, side])]] = float(blen[node, side])
    return out


def unrooted(cl, n):
    """{canonical split: length} of the unrooted tree over the leaves
    ``range(n)`` (or the leaf set ``n``), the two edges at the root merged
    into one."""
    everyone = n if isinstance(n, frozenset) else frozenset(range(n))
    out = {}
    for s, length in cl.items():
        if 1 <= len(s) < len(everyone):
            key = jtreeio.canonical_split(s, everyone)
            out[key] = out.get(key, 0.0) + length
    return out


def assert_same_unrooted(ref_cl, out_cl, n):
    ref, out = unrooted(ref_cl, n), unrooted(out_cl, n)
    assert set(ref) == set(out)
    keys = sorted(ref, key=sorted)
    np.testing.assert_allclose([out[k] for k in keys], [ref[k] for k in keys],
                               rtol=RTOL, atol=ATOL)


def assert_same_hptree(ref_cl, out_cl, assignments, n):
    """The stitched trees agree up to the edge each cluster hangs from;
    returns the number of clusters the two rooted on another edge."""
    assignments = np.asarray(assignments)
    k = int(assignments.max()) + 1
    members = [frozenset(np.flatnonzero(assignments == c).tolist())
               for c in range(k)]
    of = {leaf: c for c, mm in enumerate(members) for leaf in mm}
    # the tree over the clusters: splits made of whole clusters
    ref_u, out_u = unrooted(ref_cl, n), unrooted(out_cl, n)

    def whole(splits):
        return {s: v for s, v in splits.items()
                if all((members[of[x]] <= s) for x in s)}
    ref_w, out_w = whole(ref_u), whole(out_u)
    assert set(ref_w) == set(out_w)
    keys = sorted(ref_w, key=sorted)
    np.testing.assert_allclose([out_w[s] for s in keys],
                               [ref_w[s] for s in keys], rtol=RTOL, atol=ATOL)
    rerooted = 0
    for mm in members:
        if len(mm) < 2:
            continue
        assert mm in ref_cl and mm in out_cl      # one subtree each
        ref_in = {s: v for s, v in ref_cl.items() if s < mm}
        out_in = {s: v for s, v in out_cl.items() if s < mm}
        # each cluster's own subtree, unrooted, with its lengths
        assert_same_unrooted(ref_in, out_in, mm)
        if set(ref_in) != set(out_in):
            rerooted += 1
            continue
        keys = sorted(ref_in, key=sorted)
        np.testing.assert_allclose([out_in[s] for s in keys],
                                   [ref_in[s] for s in keys],
                                   rtol=RTOL, atol=ATOL)
    return rerooted


# ------------------------------------------------------------ core modules


@pytest.mark.parametrize("n,m,L", [(37, 11, 70), (20, 1, 33), (5, 64, 129)])
def test_cross_distance_matches_reference(n, m, L):
    a, b = _rand_msa(n, L, seed=n), _rand_msa(m, L, seed=m + 1)
    jm, jv = jdist.match_valid_counts(jnp.asarray(a), jnp.asarray(b),
                                      gap_code=GAP, n_chars=NCH)
    tm, tv = tdist.match_valid_counts(_t(a), _t(b), gap_code=GAP,
                                      n_chars=NCH)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for correct in (True, False):
        ref = jdist.cross_distance(jnp.asarray(a), jnp.asarray(b),
                                   gap_code=GAP, n_chars=NCH, correct=correct)
        out = tdist.cross_distance(_t(a), _t(b), gap_code=GAP, n_chars=NCH,
                                   correct=correct)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(
        tdist.p_distance(_t(a), gap_code=GAP, n_chars=NCH).numpy(),
        np.asarray(jdist.p_distance(jnp.asarray(a), gap_code=GAP,
                                    n_chars=NCH)), rtol=1e-6)


def _padded_stack(sizes, S, seed):
    """Padded per-cluster JC69 matrices of one simulated family (numpy)."""
    msa = _aligned_family(sum(sizes), L=240, seed=seed)
    D = np.zeros((len(sizes), S, S), np.float32)
    start = 0
    for b, s in enumerate(sizes):
        rows = msa[start:start + s]
        p = (rows[:, None, :] != rows[None, :, :]).mean(-1)
        d = -0.75 * np.log(np.clip(1.0 - 4.0 / 3.0 * p, 1e-6, 1.0))
        D[b, :s, :s] = d.astype(np.float32)
        start += s
    return D


def test_nj_batch_matches_reference():
    sizes = np.array([1, 2, 3, 29, 17, 4], np.int32)
    D = _padded_stack(sizes, 29, seed=4)
    ref = jnj.nj_batch(jnp.asarray(D), jnp.asarray(sizes))
    out = tnj.nj_batch(torch.from_numpy(D), sizes)
    np.testing.assert_array_equal(out.root.numpy(), np.asarray(ref.root))
    for b, s in enumerate(sizes):
        r = int(out.root[b])
        rc, rb = np.asarray(ref.children[b]), np.asarray(ref.blen[b])
        oc, ob = out.children[b].numpy(), out.blen[b].numpy()
        if s <= 2:   # no merge: only the root join
            np.testing.assert_array_equal(oc, rc)
            np.testing.assert_allclose(ob, rb, rtol=RTOL, atol=ATOL)
            continue
        assert jtreeio.rf_distance(ref._replace(children=rc, root=r),
                                   ref._replace(children=oc, root=r), s) == 0
        assert_same_unrooted(clades(rc, rb, r), clades(oc, ob, r), s)
        # the padding slots stay untouched
        assert (oc[2 * s - 1:] == -1).all() and (ob[2 * s - 1:] == 0).all()


def test_nj_batch_independent_of_batch():
    """A matrix's tree has the same bits alone and in any batch."""
    sizes = np.array([5, 29, 17, 3], np.int32)
    D = _padded_stack(sizes, 29, seed=6)
    whole = tnj.nj_batch(torch.from_numpy(D), sizes)
    for b in range(len(sizes)):
        alone = tnj.nj_batch(torch.from_numpy(D[b:b + 1]), sizes[b:b + 1])
        assert torch.equal(alone.children[0], whole.children[b])
        assert torch.equal(alone.blen[0], whole.blen[b])


@pytest.fixture(scope="module")
def hptree():
    """N=150, L=200, target_cluster=24, seed 2 (the geometry of
    ``tests/test_phylo_engine.py``), through both packages' cluster path
    and tiled pipeline."""
    msa = _aligned_family(150, L=200, seed=5)
    jcfg = jcluster.ClusterConfig(target_cluster=24, seed=2)
    tcfg = tcluster.ClusterConfig(target_cluster=24, seed=2)
    jacct, tacct = JTileAccountant(), TileAccountant()
    return dict(
        msa=msa,
        jc=jcluster.cluster_phylogeny(msa, gap_code=GAP, n_chars=NCH,
                                      cfg=jcfg),
        jt=jtiled(msa, tiles=_jctx(row_block=32, accountant=jacct), cfg=jcfg),
        tc=tcluster.cluster_phylogeny(_t(msa), gap_code=GAP, n_chars=NCH,
                                      cfg=tcfg),
        tt=tiled_phylogeny(msa, tiles=_ctx(row_block=32, accountant=tacct),
                           cfg=tcfg),
        jacct=jacct, tacct=tacct)


def test_cluster_phylogeny_matches_reference(hptree):
    ref, out = hptree["jc"], hptree["tc"]
    assert out.n_clusters == ref.n_clusters == 7
    np.testing.assert_array_equal(out.medoids, ref.medoids)
    np.testing.assert_array_equal(out.assignments, ref.assignments)
    assert out.root == ref.root
    # 1 of the 7 clusters hangs from another edge on this fixture
    assert assert_same_hptree(clades(ref.children, ref.blen, ref.root),
                              clades(out.children, out.blen, out.root),
                              ref.assignments, 150) <= 1


def test_cluster_phylogeny_small_n_matches_reference():
    """N <= 2 * target_cluster: one monolithic NJ, one cluster."""
    msa = _aligned_family(40, L=200, seed=7)
    ref = jcluster.cluster_phylogeny(msa, gap_code=GAP, n_chars=NCH)
    out = tcluster.cluster_phylogeny(_t(msa), gap_code=GAP, n_chars=NCH)
    assert out.n_clusters == ref.n_clusters == 1
    np.testing.assert_array_equal(out.medoids, ref.medoids)
    np.testing.assert_array_equal(out.assignments, ref.assignments)
    assert jtreeio.rf_distance(ref, out, 40) == 0
    assert_same_unrooted(clades(ref.children, ref.blen, ref.root),
                         clades(out.children, out.blen, out.root), 40)


def test_rebalance_and_medoids_copy_the_reference():
    rng = np.random.default_rng(3)
    xdist = rng.random((60, 5)).astype(np.float32)
    assign = np.argmin(xdist, axis=1)
    np.testing.assert_array_equal(tcluster.rebalance(assign, xdist, 13),
                                  jcluster.rebalance(assign, xdist, 13))
    Ds = np.asarray(jdist.distance_matrix(jnp.asarray(_rand_msa(30, 50)),
                                          gap_code=GAP, n_chars=NCH))
    np.testing.assert_array_equal(tcluster.farthest_point_medoids(Ds, 6),
                                  jcluster.farthest_point_medoids(Ds, 6))


# ------------------------------------------------------------------- tiles


@pytest.mark.parametrize("n,L,rb,cb", [(30, 70, 16, 16), (33, 64, 8, 16),
                                       (64, 128, 16, 64), (13, 40, 5, 7)])
def test_tile_full_equals_distance_matrix(n, L, rb, cb):
    msa = _rand_msa(n, L, seed=n)
    for correct in (True, False):
        full = _ctx(row_block=rb, col_block=cb, correct=correct).full(msa)
        dense = tdist.distance_matrix(_t(msa), gap_code=GAP, n_chars=NCH,
                                      correct=correct).numpy()
        np.testing.assert_array_equal(full, dense)


def test_greedy_k_center_equals_farthest_point_medoids():
    msa = _rand_msa(40, 80, seed=3)
    Ds = tdist.distance_matrix(_t(msa), gap_code=GAP, n_chars=NCH).numpy()
    picks = _ctx(row_block=16).greedy_k_center(msa, 5)
    np.testing.assert_array_equal(picks,
                                  tcluster.farthest_point_medoids(Ds, 5))
    np.testing.assert_array_equal(picks, _jctx(row_block=16)
                                  .greedy_k_center(msa, 5))


def test_strips_respect_budget():
    msa = _rand_msa(50, 60, seed=1)
    acct = TileAccountant()
    ctx = _ctx(row_block=16, accountant=acct)
    for start, stop, strip in ctx.strips(msa):
        assert strip.shape == (stop - start, 50)
        assert acct.resident == 16 * 50 * 4
    assert acct.resident == 0 and acct.peak == 16 * 50 * 4


def test_tile_methods_count_the_reference_bytes():
    """Every method counts the reference's bytes; ``nearest_assign``
    counts the strips of the reference's ``nearest`` without its tracked
    (N, k) result."""
    msa = _rand_msa(45, 60, seed=2)
    jc, tc = _jctx(row_block=16, col_block=8), _ctx(row_block=16,
                                                    col_block=8)
    for ctx in (jc, tc):
        ctx.row_sums(msa)
        ctx.release(ctx.full(msa))
        ctx.greedy_k_center(msa[:20], 3)
    assert tc.accountant.stats() == jc.accountant.stats()
    near = jc.nearest(msa, msa[:4])
    jc.release(near)
    assign, own = tc.nearest_assign(msa, msa[:4])
    np.testing.assert_array_equal(assign, np.argmin(near, axis=1))
    np.testing.assert_allclose(own, near[np.arange(45), assign], rtol=1e-6)
    ref = jc.accountant.stats()
    assert tc.accountant.stats() == dict(
        ref, n_tiles=ref["n_tiles"] - 1,
        total_tile_bytes=ref["total_tile_bytes"] - 45 * 4 * 4)


def test_tiled_pipeline_equals_port_cluster_path_bitwise(hptree):
    c, t = hptree["tc"], hptree["tt"]
    np.testing.assert_array_equal(t.medoids, c.medoids)
    np.testing.assert_array_equal(t.assignments, c.assignments)
    np.testing.assert_array_equal(t.children, c.children)
    np.testing.assert_array_equal(t.blen, c.blen)
    assert t.root == c.root
    assert ttreeio.to_newick(t.children, t.blen, t.root) == \
        ttreeio.to_newick(c.children, c.blen, c.root)


def streamed_stats(ref_stats, msa, medoids, assignments, rb):
    """The reference pipeline's tile stats with its (N, k) assignment
    matrix taken out and the port's strips of moving rows put in (one per
    ``rb`` movers, counted at ``rb`` rows), and its per-cluster stage
    recounted: the reference tracks, per chunk of strip // per - 1
    clusters, a host stack plus one transient matrix per non-empty
    cluster; the port counts, per chunk of strip // per clusters, the one
    device stack its single launch gives (per = cap^2 * 4 bytes). Both
    stages peak at (strip // per) * per when k >= strip // per. Exact
    where the (N, k) matrix and its strip do not set the reference's
    peak, as in these fixtures."""
    n, k = len(assignments), len(medoids)
    nearest = _ctx(row_block=rb).nearest_assign(msa, msa[medoids])[0]
    blocks = -(-int((nearest != assignments).sum()) // rb)
    assert ref_stats["peak_resident_bytes"] > (n + rb) * k * 4
    sizes = np.bincount(assignments, minlength=k)
    per = max(int(sizes.max()), 3) ** 2 * 4
    fits = rb * n * 4 // per
    assert k >= fits
    ref_chunks = -(-k // max(1, fits - 1))
    port_chunks = -(-k // max(1, fits))
    nonempty = int((sizes > 0).sum())
    return dict(ref_stats, n_tiles=ref_stats["n_tiles"] - 1 + blocks
                - ref_chunks - nonempty + port_chunks,
                total_tile_bytes=ref_stats["total_tile_bytes"]
                - n * k * 4 + blocks * rb * k * 4 - nonempty * per)


def test_tiled_pipeline_matches_reference(hptree):
    ref, out = hptree["jt"], hptree["tt"]
    np.testing.assert_array_equal(out.medoids, ref.medoids)
    np.testing.assert_array_equal(out.assignments, ref.assignments)
    assert assert_same_hptree(clades(ref.children, ref.blen, ref.root),
                              clades(out.children, out.blen, out.root),
                              ref.assignments, 150) <= 1     # 1 of 7
    assert hptree["tacct"].stats() == streamed_stats(
        hptree["jacct"].stats(), hptree["msa"], out.medoids,
        out.assignments, 32)
    sets = ttreeio.leaf_sets(out.children, out.root, 150)
    assert sets[out.root] == frozenset(range(150))


@pytest.mark.parametrize("n,cap,seed", [(300, 30, 0), (500, 20, 1),
                                        (64, 3, 2)])
def test_rebalance_rows_equals_rebalance(n, cap, seed):
    """The streamed spill makes the reference's moves, asking only for
    the rows that move."""
    rng = np.random.default_rng(seed)
    k = -(-3 * n // (2 * cap)) if n > 64 else 32
    xdist = rng.random((n, k)).astype(np.float32)
    xdist[:, 0] *= 0.1                       # one crowded cluster
    assign = np.argmin(xdist, axis=1)
    asked = []

    def pref_rows(idx):
        asked.extend(idx.tolist())
        return np.argsort(xdist[idx], axis=1)
    out = tcluster.rebalance_rows(assign, xdist[np.arange(n), assign], cap,
                                  k, pref_rows, step=16)
    ref = jcluster.rebalance(assign, xdist, cap)
    np.testing.assert_array_equal(out, ref)
    assert sorted(asked) == sorted(np.flatnonzero(ref != assign).tolist())
    assert np.bincount(out, minlength=k).max() <= cap


def test_per_cluster_squares_are_one_call_per_chunk(hptree, monkeypatch):
    """The per-cluster matrices are one ``match_valid_groups`` call: one
    for the cluster path, one per chunk of strip // (cap^2 * 4) clusters
    for the tiled pipeline (a single launch each on the card)."""
    from repro_torch.kernels.distance import ops
    calls = []
    real = ops.match_valid_groups

    def count(msa, index, **kw):
        calls.append(tuple(index.shape))
        return real(msa, index, **kw)
    monkeypatch.setattr(ops, "match_valid_groups", count)
    msa, cfg = hptree["msa"], tcluster.ClusterConfig(target_cluster=24,
                                                     seed=2)
    c = tcluster.cluster_phylogeny(_t(msa), gap_code=GAP, n_chars=NCH,
                                   cfg=cfg)
    sizes = np.bincount(c.assignments, minlength=c.n_clusters)
    cap = max(int(sizes.max()), 3)
    assert calls == [(c.n_clusters, cap)]
    calls.clear()
    t = tiled_phylogeny(msa, tiles=_ctx(row_block=16), cfg=cfg)
    per_chunk = 16 * 150 * 4 // (cap * cap * 4)
    k = c.n_clusters
    assert calls == [(min(per_chunk, k - c0), cap)
                     for c0 in range(0, k, per_chunk)]
    assert len(calls) > 1
    np.testing.assert_array_equal(t.children, c.children)
    np.testing.assert_array_equal(t.blen, c.blen)


def test_tiled_pipeline_memory_bound():
    """Resident distance storage stays <= one (row_block, N) strip."""
    n = 300
    msa = _aligned_family(n, L=200, seed=8)
    acct = TileAccountant()
    tiled_phylogeny(msa, tiles=_ctx(row_block=32, accountant=acct),
                    cfg=tcluster.ClusterConfig(target_cluster=24, seed=0))
    assert 0 < acct.peak <= 32 * n * 4
    assert acct.resident == 0


# ------------------------------------------------------------------ engine


def test_resolve_tree_backend_matches_reference():
    grid = [(b, n, thr, rb) for b in ("auto", "dense", "tiled", "cluster")
            for n in (2, 40, 64, 65, 128, 129, 4096, 4097, 10**6)
            for thr in (16, 64, 199) for rb in (64, 128)]
    for b, n, thr, rb in grid:
        assert resolve_tree_backend(b, n=n, cluster_threshold=thr,
                                    row_block=rb) == \
            jresolve(b, n=n, cluster_threshold=thr, row_block=rb), \
            (b, n, thr, rb)
    for r in (jresolve, resolve_tree_backend):
        with pytest.raises(ValueError):
            r("hptree", n=10)


@pytest.mark.parametrize("backend,n,kw", [
    ("dense", 40, {}),
    ("tiled", 40, dict(row_block=64, col_block=16)),     # tiled-exact
    ("cluster", 40, dict(cluster_threshold=16, target_cluster=12)),
    ("tiled", 150, dict(row_block=32, target_cluster=24, seed=2)),
    ("auto", 150, dict(target_cluster=24, seed=2)),
])
def test_tree_engine_matches_reference(backend, n, kw):
    msa = _aligned_family(n, L=200, seed={40: 7, 150: 5}[n])
    ref = JTreeEngine(gap_code=GAP, n_chars=NCH, backend=backend,
                      **kw).build(msa)
    acct = TileAccountant()
    out = TreeEngine(gap_code=GAP, n_chars=NCH, backend=backend,
                     device="cpu", **kw).build(msa, accountant=acct)
    assert out.backend == ref.backend and out.requested == backend
    if out.tile_stats is not None:   # the caller's accountant was used
        assert dict(acct.stats(), row_block_bytes=out.tile_stats[
            "row_block_bytes"]) == out.tile_stats
    assert out.n_leaves == ref.n_leaves == n
    if ref.backend == "tiled":
        cp = tcluster.cluster_phylogeny(_t(msa), gap_code=GAP, n_chars=NCH,
                                        cfg=tcluster.ClusterConfig(
                                            target_cluster=24, seed=2))
        assert out.tile_stats == dict(
            streamed_stats(ref.tile_stats, msa, cp.medoids, cp.assignments,
                           kw["row_block"]))
    else:
        assert out.tile_stats == ref.tile_stats
    ref_cl = clades(ref.children, ref.blen, ref.root)
    out_cl = clades(out.children, out.blen, out.root)
    if ref.backend in ("dense", "tiled-exact"):
        assert jtreeio.rf_distance(ref, out, n) == 0
        assert_same_unrooted(ref_cl, out_cl, n)
    else:
        cfg = jcluster.ClusterConfig(
            target_cluster=kw.get("target_cluster", 64), seed=kw.get("seed",
                                                                     0))
        assign = jcluster.cluster_phylogeny(msa, gap_code=GAP, n_chars=NCH,
                                            cfg=cfg).assignments
        # 1 of the 4 (n=40) or 7 (n=150) clusters hangs from another edge
        assert assert_same_hptree(ref_cl, out_cl, assign, n) <= 1


def test_tree_engine_cache_and_two_leaves():
    msa = _rand_msa(2, 60, seed=4)
    cache = {}
    eng = TreeEngine(gap_code=GAP, n_chars=NCH, device="cpu")
    res = eng.build(msa, cache=cache, cache_key="k")
    assert res.backend == "dense" and res.n_leaves == 2
    assert eng.build(None, cache=cache, cache_key="k") is res
    nwk = res.newick(["a", "b"])
    assert nwk.count(",") == 1 and "a" in nwk and "b" in nwk


def test_unported_tree_options_raise():
    """A mesh is ported: in a world of one the strips, the assignment and
    the tiled tree are bitwise those without one."""
    from repro_torch.launch import mesh as lm
    msa = _rand_msa(30, 40)
    with lm.world("cpu"):
        mesh = lm.mesh_from_arg(None, device="cpu")
        ctx = _ctx(mesh=mesh, row_block=8)
        strips = [s for _, _, s in ctx.strips(msa)]
        near = ctx.nearest_assign(msa, msa[:3])
        tree = TreeEngine(gap_code=GAP, n_chars=NCH, backend="tiled",
                          row_block=8, target_cluster=6, mesh=mesh,
                          device="cpu").build(msa)
    one = _ctx(row_block=8)
    assert np.concatenate(strips).tobytes() == np.concatenate(
        [s for _, _, s in one.strips(msa)]).tobytes()
    for a, b in zip(near, one.nearest_assign(msa, msa[:3])):
        assert a.tobytes() == b.tobytes()
    want = TreeEngine(gap_code=GAP, n_chars=NCH, backend="tiled",
                      row_block=8, target_cluster=6,
                      device="cpu").build(msa)
    assert tree.backend == want.backend == "tiled"
    assert tree.children.tobytes() == want.children.tobytes()
    assert tree.blen.tobytes() == want.blen.tobytes()
    # refine="search" is ported: it runs on any backend's tree
    res = TreeEngine(gap_code=GAP, n_chars=NCH, backend="tiled",
                     refine="search", model="jc69", starts=2, spr_radius=1,
                     search_rounds=1, ml_steps=5,
                     device="cpu").build(_rand_msa(8, 30))
    assert res.backend == "tiled-exact+search" and res.model == "jc69"
    assert len(res.search["trajectories"]) == 2


# -------------------------------------------------------------- likelihood


def test_jc69_transition_matches_reference():
    t = np.array([0.0, 1e-4, 0.05, 0.7, 3.0, -0.2], np.float32)
    np.testing.assert_allclose(tlik.jc69_transition(_t(t)).numpy(),
                               np.asarray(jlik.jc69_transition(jnp.asarray(t))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("tree", ["nj", "hptree"])
def test_log_likelihood_matches_reference(tree, hptree):
    if tree == "nj":
        msa = _rand_msa(30, 90, seed=12)   # gaps and N included
        ref = JTreeEngine(gap_code=GAP, n_chars=NCH,
                          backend="dense").build(msa)
        children, blen, root = ref.children, ref.blen, ref.root
    else:   # a stitched tree, its nodes numbered by the stitch
        msa = hptree["msa"]
        children, blen, root = (hptree["jc"].children, hptree["jc"].blen,
                                hptree["jc"].root)
    ref_ll = float(jlik.log_likelihood(jnp.asarray(msa),
                                       jnp.asarray(children),
                                       jnp.asarray(blen), root,
                                       gap_code=GAP))
    out_ll = float(tlik.log_likelihood(_t(msa), children, blen, root,
                                       gap_code=GAP))
    assert np.isfinite(out_ll)
    np.testing.assert_allclose(out_ll, ref_ll, rtol=1e-5)
