"""Port parity: ``repro_torch.search`` and its launcher against ``repro.search``.

On the planted family of ``tests/test_search.py`` (a mutated family in a
database of decoys), on the CPU: seed counts equal the JAX
``seed_counts_batch``; hits equal the JAX ``SearchEngine``'s field for
field under local rescoring and under global rescoring on both banded
names (the JAX ``banded`` backend is the oracle for both: its fused
Pallas kernel does not run under the local JAX); an index saved by
either package loads in the other with the same fingerprint; and the
``--pipeline --bootstrap 0`` family alignment is byte-identical to the
JAX run's, with its tree at RF = 0.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import search_run as jrun
from repro.search import SearchConfig as JConfig
from repro.search import SearchEngine as JEngine
from repro.search import SearchIndex as JIndex
from repro.search import seed_counts_batch as j_seed_counts
from repro_torch.launch import search_run as trun
from repro_torch.search import SearchConfig, SearchEngine, SearchIndex
from repro_torch.search import seed_counts_batch
from test_torch_msa_run import _splits, one_torch_thread  # noqa: F401

GATES = dict(max_hits=6, max_evalue=1e-6)


def _family_db(seed=0, n_members=4, n_decoys=4, L=120):
    rng = np.random.default_rng(seed)

    def rseq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    def mut(s, p=0.06):
        return "".join("ACGT"[rng.integers(0, 4)] if rng.random() < p else x
                       for x in s)

    base = rseq(L)
    names = [f"fam_m{j}" for j in range(n_members)] + \
        [f"decoy{j}" for j in range(n_decoys)]
    seqs = [mut(base) for _ in range(n_members)] + \
        [rseq(L) for _ in range(n_decoys)]
    return names, seqs, mut(base)


@pytest.fixture(scope="module")
def planted():
    names, seqs, query = _family_db()
    jeng = JEngine(JConfig(**GATES))
    teng = SearchEngine(SearchConfig(**GATES), device="cpu")
    return names, seqs, query, jeng.build_index(names, seqs), \
        teng.build_index(names, seqs)


def _queries(query):
    # the planted homolog, a random sequence, an empty and a short query
    rng = np.random.default_rng(9)
    return (["q", "rnd", "empty", "tiny"],
            [query, "".join("ACGT"[i] for i in rng.integers(0, 4, 100)),
             "", "ACG"])


def test_index_and_seed_counts_equal_reference(planted):
    _, _, query, jidx, tidx = planted
    assert tidx.fingerprint() == jidx.fingerprint()
    np.testing.assert_array_equal(tidx.tables, np.asarray(jidx.tables))
    names, seqs = _queries(query)
    jeng = JEngine(JConfig(**GATES))
    Q, qlens = (np.array(x) for x in jeng._encode_queries(seqs))
    kw = dict(k=jidx.k, stride=1, max_anchors=32, max_seg=1 << 20)
    ref = j_seed_counts(jnp.asarray(Q), jnp.asarray(qlens, jnp.int32),
                        jnp.asarray(jidx.lens), jnp.asarray(jidx.tables),
                        **kw)
    got = seed_counts_batch(torch.from_numpy(Q), torch.from_numpy(qlens),
                            torch.from_numpy(tidx.lens),
                            torch.from_numpy(tidx.tables), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0].min() > 0             # the planted homolog seeds everywhere


@pytest.mark.parametrize("score,backend", [
    ("local", "auto"), ("global", "banded"), ("global", "banded-pallas")])
def test_hits_equal_reference(planted, score, backend):
    _, _, query, jidx, tidx = planted
    names, seqs = _queries(query)
    local = score == "local"
    ref = JEngine(JConfig(local=local, backend="auto" if local else "banded",
                          **GATES)).search(names, seqs, jidx)
    got = SearchEngine(SearchConfig(local=local, backend=backend, **GATES),
                       device="cpu").search(names, seqs, tidx)
    assert got["queries"] == ref["queries"]
    assert got["queries"][0]["hits"][0]["target"].startswith("fam_")
    assert got["stats"] == ref["stats"]


def test_prefiltered_topk_matches_exhaustive(planted):
    _, _, query, _, tidx = planted
    eng = SearchEngine(SearchConfig(**GATES), device="cpu")
    fast = eng.search(["q"], [query], tidx)
    oracle = eng.search(["q"], [query], tidx, exhaustive=True)
    assert fast["queries"][0]["hits"] == oracle["queries"][0]["hits"]
    assert fast["stats"]["candidates"] <= oracle["stats"]["candidates"]


def test_index_files_cross_load(planted, tmp_path):
    _, _, query, jidx, tidx = planted
    jidx.save(tmp_path / "jax.npz")
    tidx.save(tmp_path / "torch.npz")
    from_jax = SearchIndex.load(tmp_path / "jax.npz")
    from_torch = JIndex.load(tmp_path / "torch.npz")
    assert from_jax.fingerprint() == jidx.fingerprint()
    assert from_torch.fingerprint() == tidx.fingerprint()
    assert from_jax.names == jidx.names
    eng = SearchEngine(SearchConfig(**GATES), device="cpu")
    assert json.dumps(eng.search(["q"], [query], from_jax)) == \
        json.dumps(eng.search(["q"], [query], tidx))
    np.savez(tmp_path / "future.npz", version=np.int32(99))
    with pytest.raises(ValueError, match="format v99"):
        SearchIndex.load(tmp_path / "future.npz")


def test_engine_refuses_a_mesh_and_defaults_to_the_card(planted,
                                                        monkeypatch):
    """A mesh is ported: in a world of one the seed counts and hits are
    the engine's without one (the hits' ``seed`` stat aside). Without a
    card the default device raises."""
    from repro_torch.launch import mesh as lm
    names, seqs, query, _, tidx = planted
    qn, qs = _queries(query)
    host = SearchEngine(SearchConfig(**GATES), device="cpu")
    with lm.world("cpu"):
        mesh = lm.mesh_from_arg(None, device="cpu")
        eng = SearchEngine(SearchConfig(**GATES), mesh=mesh, device="cpu")
        Q, qlens = eng._encode_queries(qs)
        np.testing.assert_array_equal(eng.seed_counts(Q, qlens, tidx),
                                      host.seed_counts(Q, qlens, tidx))
        got = eng.search(qn, qs, tidx)
    ref = host.search(qn, qs, tidx)
    assert got["stats"].pop("seed") == "mesh"
    assert ref["stats"].pop("seed") == "host"
    assert got == ref
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        SearchEngine(SearchConfig())


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("search_run")
    names, seqs, query = _family_db(seed=3, n_decoys=3, L=100)
    (d / "db.fasta").write_text("".join(f">{n}\n{s}\n"
                                        for n, s in zip(names, seqs)))
    (d / "q.fasta").write_text(f">query\n{query}\n")
    common = ["--db", str(d / "db.fasta"), "--query", str(d / "q.fasta"),
              "--max-hits", "4", "--max-evalue", "1e-6", "--pipeline",
              "--bootstrap", "0", "--score", "global"]
    jrun.main(common + ["--out", str(d / "jax"), "--backend", "banded"])
    trun.main(common + ["--out", str(d / "torch"), "--backend",
                        "banded-pallas", "--device", "cpu"])
    return d


def test_pipeline_family_byte_identical(pipeline_runs):
    d = pipeline_runs
    ref = json.loads((d / "jax" / "hits.json").read_text())
    got = json.loads((d / "torch" / "hits.json").read_text())
    assert got["queries"] == ref["queries"]
    fam = "family_000_query"
    assert (d / "torch" / fam / "aligned.fasta").read_bytes() == \
        (d / "jax" / fam / "aligned.fasta").read_bytes()
    names = ["query"] + [h["target"] for h in ref["queries"][0]["hits"]]
    assert len(names) == 5
    ref_splits = _splits((d / "jax" / fam / "tree.nwk").read_text(), names)
    assert _splits((d / "torch" / fam / "tree.nwk").read_text(),
                   names) == ref_splits


@pytest.mark.parametrize("flags", [["--dist"], ["--mesh", "1x1"],
                                   ["--bootstrap", "1"]])
def test_unported_flags_name_the_roadmap(pipeline_runs, flags, tmp_path,
                                         capsys):
    """``--bootstrap`` is ported: the family tree is ML-refined and
    carries support. ``--dist``/``--mesh`` are ported: in a world of one
    on the CPU the hits and the family's files are the host run's (the
    hits' ``seed`` stat aside), and a mesh larger than the world is
    refused."""
    d = pipeline_runs
    if flags[0] == "--bootstrap":
        trun.main(["--db", str(d / "db.fasta"), "--query",
                   str(d / "q.fasta"), "--out", str(tmp_path),
                   "--device", "cpu", "--max-hits", "4", "--max-evalue",
                   "1e-6", "--pipeline", "--score", "global",
                   "--ml-steps", "10", *flags])
        fam = json.loads((tmp_path / "report.json").read_text())[
            "families"][0]
        assert fam["refine"] == "ml" and fam["tree_backend"] == "dense+ml"
        assert 0.0 <= fam["mean_support"] <= 1.0
        return
    common = ["--db", str(d / "db.fasta"), "--query", str(d / "q.fasta"),
              "--max-hits", "4", "--max-evalue", "1e-6", "--pipeline",
              "--bootstrap", "0", "--score", "global", "--backend",
              "banded-pallas", "--device", "cpu"]
    trun.main(common + ["--out", str(tmp_path / "mesh"), *flags])
    got = json.loads((tmp_path / "mesh" / "hits.json").read_text())
    ref = json.loads((d / "torch" / "hits.json").read_text())
    assert got["stats"].pop("seed") == "mesh"
    assert ref["stats"].pop("seed") == "host"
    assert got == ref
    fam = "family_000_query"
    for f in ("aligned.fasta", "tree.nwk"):
        assert (tmp_path / "mesh" / fam / f).read_bytes() == \
            (d / "torch" / fam / f).read_bytes()
    with pytest.raises(ValueError, match="needs 2 ranks, the world has 1"):
        trun.main(common + ["--out", str(tmp_path / "never"), "--mesh",
                            "2x1"])
    assert not (tmp_path / "never").exists()


def test_search_run_defaults_to_the_card(pipeline_runs, monkeypatch):
    d = pipeline_runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--db", str(d / "db.fasta"), "--query",
                   str(d / "q.fasta"), "--out", str(d / "never"),
                   "--score", "global", "--backend", "banded-pallas"])
    assert not (d / "never").exists()
