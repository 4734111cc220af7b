"""The ML launch paths: ``msa_run --tree ml``, ``tree_run --refine ml
--bootstrap`` and ``search_run --pipeline --bootstrap`` of the port (on
the CPU) against the JAX CLIs on the same FASTA, and the engine's ML
fields.

Reports: the same keys, effective backend, selected model and ``n_nni``;
initial logL at rtol=1e-5, final logL within 1e-4 * |logL| and not below
the reference's by more than that; the trees at RF 0 (unrooted). The
bootstrap draws come from each package's own RNG (ROADMAP.md §3), so
supports are checked for range and placement, not value.
"""
import json
import re

import numpy as np
import pytest
import torch

from repro.data import SimConfig, simulate_family, write_fasta
from repro.launch import msa_run as jmsa_run
from repro.launch import search_run as jsearch_run
from repro.launch import tree_run as jtree_run
from repro_torch.launch import msa_run as tmsa_run
from repro_torch.launch import search_run as tsearch_run
from repro_torch.launch import tree_run as ttree_run
from repro_torch.phylo import TreeEngine
from test_torch_msa_run import _splits, one_torch_thread  # noqa: F401
from test_torch_search import _family_db


def _report(path):
    return json.loads((path / "report.json").read_text())


def _close_logl(out, ref):
    np.testing.assert_allclose(out["initial"], ref["initial"], rtol=1e-5)
    tol = 1e-4 * abs(ref["final"])
    assert abs(out["final"] - ref["final"]) <= tol
    assert out["final"] >= ref["final"] - tol
    assert out["final"] >= out["initial"]


def _topology(newick, names):
    """``_splits`` of a Newick string with its support labels dropped."""
    return _splits(re.sub(r"\)[0-9.]+", ")", newick), names)


def _supports(newick):
    """Support labels of a Newick string (numbers right after ')')."""
    return [float(x) for x in re.findall(r"\)([0-9.]+):", newick)]


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    d = tmp_path_factory.mktemp("ml")
    fam = simulate_family(SimConfig(n_leaves=9, root_len=180, seed=4,
                                    branch_sub=0.05, branch_indel=0.002))
    write_fasta(d / "in.fa", fam.names, fam.seqs)
    common = ["--fasta", str(d / "in.fa"), "--tree", "ml", "--tree-ll",
              "--k", "10"]
    jmsa_run.main([*common, "--out", str(d / "jax_msa")])
    tmsa_run.main([*common, "--out", str(d / "torch_msa"), "--device", "cpu"])
    return d, fam.names


def test_msa_run_tree_ml_matches_reference(family):
    d, names = family
    ref, out = _report(d / "jax_msa"), _report(d / "torch_msa")
    assert set(out) == set(ref)
    assert out["tree_backend"] == ref["tree_backend"] == "dense+ml"
    assert out["tree_model"] == ref["tree_model"]
    _close_logl(out["tree_logl"], ref["tree_logl"])
    np.testing.assert_allclose(out["log_likelihood"], ref["log_likelihood"],
                               rtol=1e-4)
    assert (d / "torch_msa" / "aligned.fasta").read_bytes() == \
        (d / "jax_msa" / "aligned.fasta").read_bytes()
    ref_s = _splits((d / "jax_msa" / "tree.nwk").read_text(), names)
    assert len(ref_s) == len(names) - 3
    assert _splits((d / "torch_msa" / "tree.nwk").read_text(), names) == ref_s


@pytest.mark.parametrize("model", ["auto", "gtr"])
def test_tree_run_refine_ml_bootstrap_matches_reference(family, model):
    d, names = family
    common = ["--fasta", str(d / "jax_msa" / "aligned.fasta"), "--refine",
              "ml", "--model", model, "--ml-steps", "30", "--nni-rounds", "3",
              "--bootstrap", "8", "--seed", "1"]
    jtree_run.main([*common, "--out", str(d / f"jax_tree_{model}")])
    ttree_run.main([*common, "--out", str(d / f"torch_tree_{model}"),
                    "--device", "cpu"])
    ref = _report(d / f"jax_tree_{model}")
    out = _report(d / f"torch_tree_{model}")
    assert set(out) == set(ref)
    for key in ("backend", "refine", "model", "n_nni"):
        assert out[key] == ref[key], key
    assert set(out["bic"]) == set(ref["bic"])
    _close_logl(out["logl"], ref["logl"])
    assert set(out["bootstrap"]) == set(ref["bootstrap"])
    assert out["bootstrap"]["replicates"] == 8
    assert out["bootstrap"]["bootstrap_seconds"] > 0
    nwk_ref = (d / f"jax_tree_{model}" / "tree.nwk").read_text()
    nwk = (d / f"torch_tree_{model}" / "tree.nwk").read_text()
    assert _topology(nwk, names) == _topology(nwk_ref, names)
    sup = _supports(nwk)
    assert 0 < len(sup) <= len(names) - 3
    assert all(0.0 <= x <= 1.0 for x in sup)


def test_search_run_pipeline_bootstrap_matches_reference(tmp_path):
    names, seqs, query = _family_db(seed=3, n_decoys=3, L=100)
    (tmp_path / "db.fasta").write_text("".join(
        f">{n}\n{s}\n" for n, s in zip(names, seqs)))
    (tmp_path / "q.fasta").write_text(f">query\n{query}\n")
    common = ["--db", str(tmp_path / "db.fasta"), "--query",
              str(tmp_path / "q.fasta"), "--max-hits", "4", "--max-evalue",
              "1e-6", "--pipeline", "--score", "global", "--bootstrap", "6",
              "--ml-steps", "20"]
    jsearch_run.main([*common, "--out", str(tmp_path / "jax")])
    tsearch_run.main([*common, "--out", str(tmp_path / "torch"),
                      "--device", "cpu"])
    ref = _report(tmp_path / "jax")["families"]
    out = _report(tmp_path / "torch")["families"]
    assert len(out) == len(ref) == 1
    assert set(out[0]) == set(ref[0])
    for key in ("query", "n_members", "width", "tree_backend", "refine"):
        assert out[0][key] == ref[0][key], key
    assert out[0]["refine"] == "ml"
    assert 0.0 <= out[0]["mean_support"] <= 1.0
    fam = "family_000_query"
    nwk = (tmp_path / "torch" / fam / "tree.nwk").read_text()
    nwk_ref = (tmp_path / "jax" / fam / "tree.nwk").read_text()
    got = re.findall(r"[(,]([^(),:;]+):", nwk)
    assert sorted(got) == sorted(re.findall(r"[(,]([^(),:;]+):", nwk_ref))
    assert _topology(nwk, got) == _topology(nwk_ref, got)
    assert len(got) == out[0]["n_members"] == 5
    assert _supports(nwk)


def test_engine_ml_fields_and_validation():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, 60)
    msa = np.stack([np.where(rng.random(60) < 0.1, rng.integers(0, 4, 60),
                             base) for _ in range(7)]).astype(np.int8)
    res = TreeEngine(gap_code=5, n_chars=5, refine="ml", model="jc69",
                     ml_steps=10, nni_rounds=1, bootstrap=4,
                     device="cpu").build(torch.from_numpy(msa))
    assert res.backend == "dense+ml" and res.model == "jc69"
    assert set(res.timings) >= {"refine_seconds", "bootstrap_seconds",
                                "total_seconds"}
    assert res.support.shape == (13,)
    finite = res.support[np.isfinite(res.support)]
    assert finite.size == 4 and ((finite >= 0) & (finite <= 1)).all()
    assert len(_supports(res.newick([f"s{i}" for i in range(7)]))) >= 3
    with pytest.raises(ValueError, match="bootstrap support requires"):
        TreeEngine(gap_code=5, n_chars=5, bootstrap=3,
                   device="cpu").build(msa)
    with pytest.raises(ValueError, match="nucleotide"):
        TreeEngine(gap_code=24, n_chars=24, refine="ml",
                   device="cpu").build(msa)
