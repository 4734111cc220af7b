"""The tree launchers: ``repro_torch.launch.tree_run`` against
``repro.launch.tree_run``, and ``msa_run --tree cluster|tiled|auto
--tree-ll`` against the reference's ``msa_run``.

Both launchers run in process on the same FASTA; the port on the CPU. The
reports must name the same effective backend, carry the same tile stats
and keys, and the JC69 log-likelihood at rtol=1e-5. Trees: a single NJ
tree (dense, tiled-exact, the small-N cluster branch) at RF 0; an HPTree
tree as ``tests/test_torch_tree_backends.py`` compares it (NJ roots each
cluster by rounding), on the engine results the launchers write out. The
port's refinement flags run (each checked on its report field), ``--dist``
and ``--mesh`` exit naming their ROADMAP.md item, and ``--device cuda``
without a card raises.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alphabet as jab
from repro.core import cluster as jcluster
from repro.core import likelihood as jlik
from repro.data import SimConfig, simulate_family, write_fasta
from repro.launch import msa_run as jmsa_run
from repro.launch import tree_run as jtree_run
from repro.phylo import TreeEngine as JTreeEngine
from repro_torch.launch import msa_run as tmsa_run
from repro_torch.launch import tree_run as ttree_run
from repro_torch.phylo import TreeEngine
from test_torch_msa_run import _splits, one_torch_thread  # noqa: F401
from repro_torch.core import cluster as tcluster
from test_torch_tree_backends import assert_same_hptree, clades, streamed_stats

GAP, NCH = jab.DNA.gap_code, jab.DNA.n_chars
N = 150
HPTREE = ["--target-cluster", "24", "--seed", "2"]
RUNS = {"dense": ["--backend", "dense"],
        "cluster": ["--backend", "cluster", *HPTREE],
        "tiled": ["--backend", "tiled", "--row-block", "32", *HPTREE],
        "auto": ["--backend", "auto", *HPTREE]}


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    d = tmp_path_factory.mktemp("tree_run")
    fam = simulate_family(SimConfig(n_leaves=N, root_len=200,
                                    branch_sub=0.03, branch_indel=0.0,
                                    seed=5))
    write_fasta(d / "aligned.fa", fam.names, fam.seqs)
    msa = np.asarray(jab.encode_batch(fam.seqs, jab.DNA)[0])
    return d, fam.names, msa


@pytest.fixture(scope="module")
def tree_runs(aligned):
    d, _, _ = aligned
    for label, flags in RUNS.items():
        common = ["--fasta", str(d / "aligned.fa"), "--tree-ll", *flags]
        jtree_run.main([*common, "--out", str(d / f"jax_{label}")])
        ttree_run.main([*common, "--out", str(d / f"torch_{label}"),
                        "--device", "cpu"])
    return d


def _report(d, name):
    return json.loads((d / name / "report.json").read_text())


@pytest.mark.parametrize("label,backend", [("dense", "dense"),
                                           ("cluster", "cluster"),
                                           ("tiled", "tiled"),
                                           ("auto", "cluster")])
def test_tree_run_reports_match(tree_runs, aligned, label, backend):
    ref = _report(tree_runs, f"jax_{label}")
    out = _report(tree_runs, f"torch_{label}")
    assert set(out) == set(ref)
    assert out["backend"] == ref["backend"] == backend
    skip = {"tree_seconds", "log_likelihood", "tile_stats"}
    assert {k: out[k] for k in out if k not in skip} == \
        {k: ref[k] for k in ref if k not in skip}
    assert np.isfinite(out["log_likelihood"])
    if label == "tiled":
        stats = out["tile_stats"]
        assert stats["row_block_bytes"] == 32 * N * 4
        assert 0 < stats["peak_resident_bytes"] <= stats["row_block_bytes"]
        cp = tcluster.cluster_phylogeny(
            torch.from_numpy(aligned[2].copy()), gap_code=GAP, n_chars=NCH,
            cfg=tcluster.ClusterConfig(target_cluster=24, seed=2))
        assert stats == streamed_stats(ref["tile_stats"], aligned[2],
                                       cp.medoids, cp.assignments, 32)
    else:
        assert out["tile_stats"] == ref["tile_stats"]


@pytest.mark.parametrize("label", ["cluster", "tiled", "auto"])
def test_tree_run_hptree_trees(tree_runs, aligned, label):
    """The launchers write their engine's trees; the port's tree agrees
    with the reference's as an HPTree tree, and the port's logL is the
    reference's likelihood of the port's tree."""
    d, names, msa = aligned
    kw = dict(gap_code=GAP, n_chars=NCH, backend=RUNS[label][1],
              target_cluster=24, seed=2,
              row_block=32 if label == "tiled" else 128)
    ref = JTreeEngine(**kw).build(msa)
    out = TreeEngine(device="cpu", **kw).build(msa)
    assert (tree_runs / f"jax_{label}" / "tree.nwk").read_text() == \
        ref.newick(names) + "\n"
    assert (tree_runs / f"torch_{label}" / "tree.nwk").read_text() == \
        out.newick(names) + "\n"
    assign = jcluster.cluster_phylogeny(
        msa, gap_code=GAP, n_chars=NCH,
        cfg=jcluster.ClusterConfig(target_cluster=24, seed=2)).assignments
    # 1 of the 7 clusters hangs from another edge on this fixture
    assert assert_same_hptree(clades(ref.children, ref.blen, ref.root),
                              clades(out.children, out.blen, out.root),
                              assign, N) <= 1
    ref_ll = float(jlik.log_likelihood(jnp.asarray(msa),
                                       jnp.asarray(out.children),
                                       jnp.asarray(out.blen), out.root,
                                       gap_code=GAP))
    np.testing.assert_allclose(
        _report(tree_runs, f"torch_{label}")["log_likelihood"], ref_ll,
        rtol=1e-5)


def test_tree_run_dense_tree_and_loglik(tree_runs, aligned):
    _, names, _ = aligned
    ref = _splits((tree_runs / "jax_dense" / "tree.nwk").read_text(), names)
    out = _splits((tree_runs / "torch_dense" / "tree.nwk").read_text(), names)
    assert len(ref) == N - 3 and out == ref
    np.testing.assert_allclose(
        _report(tree_runs, "torch_dense")["log_likelihood"],
        _report(tree_runs, "jax_dense")["log_likelihood"], rtol=1e-5)


# the refinement flags (ROADMAP §1 item 9) run on 10 of the rows, each
# checked on its report field; --dist and --mesh (item 11) run in a world
# of one against the same run without them. Base settings keep every
# refinement to a few Adam steps.
_ML = ["--refine", "ml", "--model", "jc69", "--ml-steps", "5",
       "--nni-rounds", "1"]
_SEARCH = ["--refine", "search", "--model", "jc69", "--ml-steps", "5",
           "--starts", "2", "--spr-radius", "1", "--search-rounds", "1"]
_RUNS = {
    "--refine ml": (_ML, lambda r, d: r["refine"] == "ml"
                    and r["backend"] == "dense+ml"),
    "--refine search": (_SEARCH, lambda r, d: r["refine"] == "search"
                        and r["backend"] == "dense+search"),
    "--bootstrap": (_ML + ["--bootstrap", "5"],
                    lambda r, d: r["bootstrap"]["replicates"] == 5
                    and 0 <= r["bootstrap"]["mean_support"] <= 1),
    "--restartable": (_SEARCH + ["--restartable"],
                      lambda r, d: r["search"]["ckpt_dir"]
                      == str(d / "search_ckpt")
                      and (d / "search_ckpt").is_dir()),
    "--ckpt-dir": (_SEARCH + ["--ckpt-dir", "CK"],
                   lambda r, d: r["search"]["ckpt_dir"] == str(d / "ck")
                   and (d / "ck").is_dir()),
    "--resume": (_SEARCH + ["--restartable", "--resume"],
                 lambda r, d: len(r["search"]["trajectories"]) == 2),
    "--model": (_ML[:2] + ["--model", "k80", "--ml-steps", "5",
                           "--nni-rounds", "0"],
                lambda r, d: r["model"] == "k80" and set(r["bic"]) == {"k80"}),
    "--ml-steps": (_ML[:4] + ["--ml-steps", "0", "--nni-rounds", "0"],
                   lambda r, d: abs(r["logl"]["final"] - r["logl"]["initial"])
                   <= 1e-4 * abs(r["logl"]["initial"])),
    "--nni-rounds": (_ML[:6] + ["--nni-rounds", "0"],
                     lambda r, d: r["n_nni"] == 0),
    "--starts": (_SEARCH[:8] + ["--starts", "3"] + _SEARCH[8:],
                 lambda r, d: r["search"]["starts"] == 3
                 and r["search"]["start_labels"] == ["nj", "cluster",
                                                     "random2"]),
    "--spr-radius": (_SEARCH, lambda r, d: r["search"]["spr_radius"] == 1),
    "--search-rounds": (_SEARCH,
                        lambda r, d: len(r["search"]["round_seconds"]) == 2),
}


@pytest.fixture(scope="module")
def small(aligned):
    d, names, msa = aligned
    fa = d / "small.fa"
    write_fasta(fa, names[:10], [jab.DNA.decode(r) for r in msa[:10]])
    return fa


@pytest.mark.parametrize("flags,item", [
    (["--refine", "ml"], "item 9"), (["--refine", "search"], "item 9"),
    (["--bootstrap"], "item 9"), (["--restartable"], "item 9"),
    (["--ckpt-dir"], "item 9"), (["--resume"], "item 9"),
    (["--model"], "item 9"), (["--ml-steps"], "item 9"),
    (["--nni-rounds"], "item 9"), (["--starts"], "item 9"),
    (["--spr-radius"], "item 9"), (["--search-rounds"], "item 9"),
    (["--dist"], "item 11"), (["--mesh", "1x1"], "item 11")])
def test_tree_run_unported_flags_name_the_roadmap(aligned, small, flags,
                                                  item, tmp_path, capsys):
    """Item 9's flags are ported: each runs on the CPU and shows in its
    report field. Item 11's are ported too: ``--dist`` (the tiled
    backend's strips over the mesh) and ``--mesh 1x1`` (ML bootstrap over
    the mesh) in a world of one give the Newick of the same run without
    them."""
    d, _, _ = aligned
    if item == "item 9":
        argv, check = _RUNS[" ".join(flags)]
        out = tmp_path / "out"
        argv = [str(out / "ck") if a == "CK" else a for a in argv]
        ttree_run.main(["--fasta", str(small), "--device", "cpu",
                        "--out", str(out), *argv])
        report = _report(tmp_path, "out")
        assert check(report, out), report
        assert (out / "tree.nwk").read_text().count(",") == 9
        return
    extra = (["--backend", "tiled", "--row-block", "4", "--target-cluster",
              "4"] if flags == ["--dist"] else _ML + ["--bootstrap", "5"])
    for name, f in (("mesh", flags + extra), ("one", extra)):
        ttree_run.main(["--fasta", str(small), "--device", "cpu",
                        "--out", str(tmp_path / name), *f])
    assert (tmp_path / "mesh" / "tree.nwk").read_bytes() == \
        (tmp_path / "one" / "tree.nwk").read_bytes()
    assert _report(tmp_path, "mesh")["backend"] == (
        "tiled" if flags == ["--dist"] else "dense+ml")


def test_tree_run_cuda_without_card_raises(aligned, monkeypatch):
    d, _, _ = aligned
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttree_run.main(["--fasta", str(d / "aligned.fa"),
                        "--out", str(d / "never_cuda")])
    assert not (d / "never_cuda").exists()


def test_encode_aligned_rows_matches_encode_aligned():
    from repro_torch.core import alphabet as tab
    seqs = ["ACGT-NRY", "acgt-nxT", "--------"]
    for alpha in (tab.DNA, tab.PROTEIN):
        np.testing.assert_array_equal(
            alpha.encode_aligned_rows(seqs),
            np.stack([alpha.encode_aligned(s) for s in seqs]))


# ------------------------------------------------------------------ msa_run

MSA_RUNS = {"cluster": ["--tree", "cluster", "--cluster-threshold", "4",
                        "--tree-ll"],
            "tiled": ["--tree", "tiled", "--tree-ll"],
            "auto": ["--tree", "auto", "--cluster-threshold", "4"]}


@pytest.fixture(scope="module")
def msa_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("msa_run_tree")
    fam = simulate_family(SimConfig(n_leaves=24, root_len=300, seed=6,
                                    branch_sub=0.02, branch_indel=0.001))
    write_fasta(d / "in.fa", fam.names, fam.seqs)
    for label, flags in MSA_RUNS.items():
        common = ["--fasta", str(d / "in.fa"), "--k", "10", *flags]
        jmsa_run.main([*common, "--out", str(d / f"jax_{label}")])
        tmsa_run.main([*common, "--out", str(d / f"torch_{label}"),
                       "--device", "cpu"])
    return d, fam.names


@pytest.mark.parametrize("label,backend", [("cluster", "cluster"),
                                           ("tiled", "tiled-exact"),
                                           ("auto", "cluster")])
def test_msa_run_tree_backends_match(msa_runs, label, backend):
    d, names = msa_runs
    ref = _report(d, f"jax_{label}")
    out = _report(d, f"torch_{label}")
    assert set(out) == set(ref)
    assert out["tree_backend"] == ref["tree_backend"] == backend
    assert out.get("tile_stats") == ref.get("tile_stats")
    assert ("log_likelihood" in out) == (label != "auto")
    if "log_likelihood" in out:
        np.testing.assert_allclose(out["log_likelihood"],
                                   ref["log_likelihood"], rtol=1e-5)
    assert (d / f"torch_{label}" / "aligned.fasta").read_bytes() == \
        (d / f"jax_{label}" / "aligned.fasta").read_bytes()
    ref_s = _splits((d / f"jax_{label}" / "tree.nwk").read_text(), names)
    assert len(ref_s) == len(names) - 3
    assert _splits((d / f"torch_{label}" / "tree.nwk").read_text(),
                   names) == ref_s
