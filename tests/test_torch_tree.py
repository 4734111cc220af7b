"""Port parity: neighbor joining, Newick output and the tree engine.

The same distance matrix (from the reference's MSA of a simulated family)
goes through ``repro.core.nj`` and ``repro_torch.core.nj``. The row sums
of the Q-matrix reduce in another order, so where two joins tie (always
the case among the last four nodes) the merge order may differ: the
topology must match at RF = 0, and the length of the edge behind each
split at rtol=1e-5 (atol=1e-6 for lengths near zero).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distance as jdist
from repro.core import msa as jmsa
from repro.core import nj as jnj
from repro.core import treeio as jtreeio
from repro.data import SimConfig, simulate_family
from repro.phylo import TreeEngine as JTreeEngine
from repro_torch.core import nj as tnj
from repro_torch.core import treeio as ttreeio
from repro_torch.phylo import TreeEngine


def _edge_lengths(children, blen, root, n):
    """{canonical split: edge length} of the unrooted tree; the two edges
    at the root are one edge."""
    children, blen = np.asarray(children), np.asarray(blen)
    sets = jtreeio.leaf_sets(children, root, n)
    everyone = frozenset(range(n))
    out = {}
    for node in range(children.shape[0]):
        if children[node, 0] < 0:
            continue
        for side in (0, 1):
            split = jtreeio.canonical_split(sets[int(children[node, side])],
                                            everyone)
            out[split] = out.get(split, 0.0) + float(blen[node, side])
    return out


def _assert_same_tree(ref_arrays, out_arrays, n):
    ref = _edge_lengths(*ref_arrays, n)
    out = _edge_lengths(*out_arrays, n)
    assert sorted(ref, key=sorted) == sorted(out, key=sorted)
    keys = sorted(ref, key=sorted)
    np.testing.assert_allclose([out[k] for k in keys], [ref[k] for k in keys],
                               rtol=1e-5, atol=1e-6)


def _msa(seed, n):
    fam = simulate_family(SimConfig(n_leaves=n, root_len=300, seed=seed,
                                    branch_sub=0.05))
    return jmsa.center_star_msa(fam.seqs, jmsa.MSAConfig()).msa


@pytest.mark.parametrize("seed,n", [(0, 10), (1, 24), (2, 40)])
def test_nj_topology_and_branch_lengths(seed, n):
    msa = _msa(seed, n)
    D = np.asarray(jdist.distance_matrix(jnp.asarray(msa), gap_code=5,
                                         n_chars=5))
    ref = jnj.neighbor_joining(jnp.asarray(D), n)
    out = tnj.neighbor_joining(torch.from_numpy(D.copy()), n)
    ch, bl, root = tnj.host_tree(out)
    assert root == int(ref.root)
    assert ttreeio.rf_distance(out._replace(children=ch), ref, n) == 0
    _assert_same_tree((ref.children, ref.blen, root), (ch, bl, root), n)


def test_tree_engine_dense_matches_reference():
    msa = _msa(5, 20)
    ref = JTreeEngine(gap_code=5, n_chars=5, backend="dense").build(msa)
    out = TreeEngine(gap_code=5, n_chars=5, backend="dense",
                     device="cpu").build(msa)
    assert out.backend == ref.backend == "dense"
    assert jtreeio.rf_distance(ref, out, 20) == 0
    _assert_same_tree((ref.children, ref.blen, ref.root),
                      (out.children, out.blen, out.root), 20)
    names = [f"s{i}" for i in range(20)]
    assert out.newick(names).count("s") == ref.newick(names).count("s")


def test_treeio_copy_matches_reference():
    msa = _msa(6, 12)
    ref = JTreeEngine(gap_code=5, n_chars=5, backend="dense").build(msa)
    assert ttreeio.to_newick(ref.children, ref.blen, ref.root) == \
        jtreeio.to_newick(ref.children, ref.blen, ref.root)
    assert ttreeio.bipartitions(ref.children, ref.root, 12) == \
        jtreeio.bipartitions(ref.children, ref.root, 12)


def test_unported_tree_paths_raise():
    msa = _msa(7, 8)
    assert TreeEngine(gap_code=5, n_chars=5, backend="tiled",
                      device="cpu").build(msa).backend == "tiled-exact"
    # refine="ml" is ported: it runs and reports its model and logL
    res = TreeEngine(gap_code=5, n_chars=5, refine="ml", model="k80",
                     ml_steps=10, nni_rounds=1, device="cpu").build(msa)
    assert res.backend == "dense+ml" and res.model == "k80"
    assert res.logl["final"] >= res.logl["initial"]
    # a mesh is ported: in a world of one the tree is the engine's
    # without one; auto takes the tiled pipeline on more than one rank
    from repro_torch.dist.sharding import Mesh
    from repro_torch.launch import mesh as lm
    from repro_torch.phylo import resolve_tree_backend
    with lm.world("cpu"):
        got = TreeEngine(gap_code=5, n_chars=5, backend="tiled",
                         mesh=lm.mesh_from_arg(None, device="cpu"),
                         device="cpu").build(msa)
    assert got.newick() == TreeEngine(gap_code=5, n_chars=5,
                                      backend="tiled",
                                      device="cpu").build(msa).newick()
    two = Mesh((2, 1), ("data", "model"), None, 0, 2, torch.device("cpu"))
    assert resolve_tree_backend("auto", n=100, mesh=two) == "tiled-exact"
    assert resolve_tree_backend("auto", n=300, mesh=two) == "tiled"
    assert resolve_tree_backend("auto", n=300) == "cluster"
