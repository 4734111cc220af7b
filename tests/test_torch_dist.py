"""The port's distributed runtime (``repro_torch.dist``) in a world of one.

Each test makes a ``gloo`` world of one in this process
(``repro_torch.launch.mesh.world``: a ``HashStore``, rank 0) and holds
the port against the reference on its one CPU device:

* ``msa_over_mesh`` under kmer, plain, sw and banded (a band wider than
  any pair): byte for byte the reference's ``msa_over_mesh`` on a 1x1
  mesh and its host ``center_star_msa``; in a case where the band
  overflows, the reference's mesh result, which differs from its host
  result (asserted too, so the case keeps its meaning);
* ``msa_run --dist``'s report carries ``kmer_fallbacks: null``;
* ``BackupShardPlan``, ``pad_rows``, ``shard_rows``' refusal, the axis
  helpers and ``mesh_from_arg``: the reference's answers and messages;
* the collectives and the compressed mean: the reference's one-device
  ``shard_map`` results.

The multi-rank worlds are ``tests/test_torch_dist_ranks.py``.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.msa import MSAConfig as JConfig
from repro.core.msa import center_star_msa as j_csm
from repro.data import SimConfig, simulate_family
from repro.dist import fault as jfault
from repro.dist import mapreduce as jmr
from repro.dist import sharding as jsh
from repro.launch.mesh import make_local_mesh as jmesh
from repro_torch.core.msa import MSAConfig
from repro_torch.dist import collectives as col
from repro_torch.dist import fault as tfault
from repro_torch.dist import grad_compression as gc
from repro_torch.dist import mapreduce as tmr
from repro_torch.dist import sharding as tsh
from repro_torch.launch import mesh as lm
from repro_torch.launch import msa_run as trun
from test_torch_msa_run import one_torch_thread  # noqa: F401


@pytest.fixture
def mesh1():
    """A mesh over a world of one, torn down after the test."""
    with lm.world("cpu"):
        yield lm.mesh_from_arg(None, device="cpu")
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def family():
    return simulate_family(SimConfig(n_leaves=24, root_len=150, seed=5))


@pytest.fixture(scope="module")
def diverged():
    """A family whose pairs overflow a band of 4 or 8."""
    return simulate_family(SimConfig(n_leaves=16, root_len=200,
                                     branch_sub=0.1, branch_indel=0.03,
                                     seed=3))


CASES = {"kmer": dict(method="kmer", k=8), "plain": dict(method="plain"),
         "sw": dict(method="sw"),
         "banded": dict(method="kmer", k=8, backend="banded", band=160)}


@pytest.mark.parametrize("case", list(CASES))
def test_msa_over_mesh_equals_reference(mesh1, family, case):
    kw = CASES[case]
    got = tmr.msa_over_mesh(family.seqs, MSAConfig(**kw), mesh1)
    ref_mesh = jmr.msa_over_mesh(family.seqs, JConfig(**kw), jmesh((1, 1)))
    ref_host = j_csm(family.seqs, JConfig(**kw))
    for ref in (ref_mesh, ref_host):
        assert got.msa.shape == np.asarray(ref.msa).shape
        assert got.msa.tobytes() == np.asarray(ref.msa).tobytes()
        assert (got.center_idx, got.width) == (ref.center_idx, ref.width)
    assert got.n_fallback == ref_mesh.n_fallback == -1


@pytest.mark.parametrize("kw", [dict(method="plain", band=4),
                                dict(method="kmer", k=8, band=8)])
def test_band_overflow_keeps_the_mesh_semantics(mesh1, diverged, kw):
    """Under a mesh the band's result stands for overflowing pairs (no
    per-pair full-DP fallback), as in the reference: the port's mesh MSA
    equals the reference's mesh MSA, and differs from the host MSA."""
    kw = dict(kw, backend="banded")
    got = tmr.msa_over_mesh(diverged.seqs, MSAConfig(**kw), mesh1)
    ref_mesh = jmr.msa_over_mesh(diverged.seqs, JConfig(**kw),
                                 jmesh((1, 1)))
    ref_host = j_csm(diverged.seqs, JConfig(**kw))
    assert got.msa.tobytes() == np.asarray(ref_mesh.msa).tobytes()
    assert got.width == ref_mesh.width < ref_host.width
    assert ref_host.n_fallback > 0


def test_msa_run_dist_report(family, tmp_path):
    """``msa_run --dist`` in a world of its own: the rows of the host
    run, ``kmer_fallbacks`` null; the world is gone after."""
    from repro_torch.data import write_fasta
    write_fasta(tmp_path / "in.fa", family.names, family.seqs)
    for out, extra in (("dist", ["--dist", "--mesh", "1x1"]), ("host", [])):
        trun.main(["--fasta", str(tmp_path / "in.fa"), "--out",
                   str(tmp_path / out), "--device", "cpu", "--k", "8",
                   *extra])
    assert not dist.is_initialized()
    rep = json.loads((tmp_path / "dist" / "report.json").read_text())
    host = json.loads((tmp_path / "host" / "report.json").read_text())
    assert rep["kmer_fallbacks"] is None and host["kmer_fallbacks"] >= 0
    for f in ("aligned.fasta", "tree.nwk"):
        assert (tmp_path / "dist" / f).read_bytes() == \
            (tmp_path / "host" / f).read_bytes()


# ------------------------------------------------------------ the helpers

def test_backup_shard_plan_equals_reference():
    import itertools
    for n_hosts in range(1, 9):
        for rep in range(1, n_hosts + 1):
            for n_shards in (None, 2 * n_hosts + 1):
                ours = tfault.BackupShardPlan(n_hosts, rep, n_shards)
                ref = jfault.BackupShardPlan(n_hosts, rep, n_shards)
                assert ours.n_shards == ref.n_shards
                for s in range(ref.n_shards):
                    assert ours.owners(s) == ref.owners(s)
                deads = [h for h in range(n_hosts)] + [
                    set(c) for c in itertools.combinations(range(n_hosts),
                                                           2)]
                for dead in deads:
                    assert ours.reassignment(dead) == ref.reassignment(dead)
                    for s in range(ref.n_shards):
                        assert ours.takeover(dead, s) == \
                            ref.takeover(dead, s)
    for bad in (0, 9):
        with pytest.raises(ValueError, match=r"not in \[1, 8\]"):
            tfault.BackupShardPlan(8, bad)


def test_pad_rows_and_shard_rows(mesh1):
    x = np.arange(10, dtype=np.int8).reshape(5, 2)
    for mult, fill in ((2, 0), (4, 5), (5, 0)):
        ours, n = tmr.pad_rows(x, mult, fill=fill)
        ref, n_ref = jmr.pad_rows(x, mult, fill=fill)
        assert n == n_ref == 5
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(tmr.unpad_rows(ours, n), x)
    two = tsh.Mesh((2, 1), ("data", "model"), None, 1, 2,
                   torch.device("cpu"))
    with pytest.raises(ValueError, match=r"leading dim 5 does not divide "
                       r"axis 'data' \(size 2\); pad with"):
        tsh.shard_rows(x, two)
    np.testing.assert_array_equal(tsh.shard_rows(x[:4], two).numpy(),
                                  x[2:4])
    np.testing.assert_array_equal(tmr.shard_padded(x, two, fill=7).numpy(),
                                  [[6, 7], [8, 9], [7, 7]])
    assert tsh.shard_rows(x, mesh1).shape == (5, 2)
    assert tsh.row_spec(3) == ("data", None, None)


def test_axis_helpers_equal_reference(mesh1):
    """axis_size / maybe / first_fit on meshes of every shape the
    reference can build here (1x1), and on a 4x2 description."""
    ref = jmesh((1, 1))
    four_two = tsh.Mesh((4, 2), ("data", "model"), None, 5, 8,
                        torch.device("cpu"))
    assert four_two.coords() == {"data": 2, "model": 1}
    assert four_two.block_index("data") == 2
    assert four_two.block_index(("data", "model")) == 5
    for axes in (None, "data", "model", ("data", "model"), ()):
        assert tsh.axis_size(mesh1, axes) == jsh.axis_size(ref, axes)
        for dim in (1, 6, 7):
            assert tsh.maybe(mesh1, dim, axes) == jsh.maybe(ref, dim, axes)
    assert tsh.axis_size(four_two, ("data", "model")) == 8
    assert tsh.maybe(four_two, 6, "data") is None
    assert tsh.maybe(four_two, 8, "data") == "data"
    assert tsh.first_fit(four_two, 6, "data", "model", None) == "model"
    assert tsh.first_fit(four_two, 3, "data", "model") is None
    assert tsh.first_fit(four_two, 3, "data", None) is None
    assert tsh.first_fit(mesh1, 3, "data") == jsh.first_fit(ref, 3, "data")


def test_mesh_from_arg_and_refusals(mesh1, monkeypatch):
    from repro.launch.mesh import mesh_from_arg as j_from_arg
    for bad in ("2", "axb", "2x1x1"):
        with pytest.raises(ValueError) as ours:
            lm.mesh_from_arg(bad, device="cpu")
        with pytest.raises(ValueError) as ref:
            j_from_arg(bad)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="mesh .2, 1. needs 2 ranks, the "
                       "world has 1"):
        lm.mesh_from_arg("2x1", device="cpu")
    assert lm.mesh_from_arg("1x1", device="cpu").shape == (1, 1)
    # --dist on the card needs NCCL: no quiet switch to gloo
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        lm.backend_for("cuda")
    assert lm.backend_for("cpu") == "gloo"


# ---------------------------------------------------------- collectives

def _ref(f, *args, out_spec=None):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    fn = jsh.shard_map(lambda *a: f(*a, "data"), jmesh((1, 1)),
                       in_specs=tuple(P() for _ in args),
                       out_specs=P() if out_spec is None else out_spec,
                       check_vma=False)
    out = fn(*(jnp.asarray(a) for a in args))
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) \
        else np.asarray(out)


def test_collectives_at_one_rank_equal_reference(mesh1):
    from repro.dist import collectives as jcol
    from repro.dist import grad_compression as jgc
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    a = rng.standard_normal((4, 6)).astype(np.float32)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    t = torch.from_numpy
    assert col.ring_all_gather(t(x)).numpy().tobytes() == \
        _ref(jcol.ring_all_gather, x).tobytes()
    np.testing.assert_allclose(col.ag_matmul_overlap(t(a), t(w)).numpy(),
                               _ref(jcol.ag_matmul_overlap, a, w),
                               rtol=1e-5)
    np.testing.assert_allclose(col.psum_scatter_mean(t(x)).numpy(),
                               _ref(jcol.psum_scatter_mean, x), rtol=1e-5)
    assert col.axis_size() == 1
    g = {"w": (rng.standard_normal((5, 4)) * 2).astype(np.float32),
         "b": [rng.standard_normal(3).astype(np.float32)]}
    ef = gc.init_ef({k: (t(v) if k == "w" else [t(v[0])])
                     for k, v in g.items()})
    assert ef["w"].dtype == torch.float32 and not ef["b"][0].any()
    ef = {"w": t(rng.standard_normal((5, 4)).astype(np.float32) * 0.01),
          "b": [t(rng.standard_normal(3).astype(np.float32) * 0.01)]}
    mean, new_ef = gc.tree_compressed_psum_mean(
        {"w": t(g["w"]), "b": [t(g["b"][0])]}, None, ef)
    for got_m, got_e, gv, ev in ((mean["w"], new_ef["w"], g["w"], ef["w"]),
                                 (mean["b"][0], new_ef["b"][0], g["b"][0],
                                  ef["b"][0])):
        ref_m, ref_e = _ref(
            lambda gv_, ev_, ax: jgc.compressed_psum_mean(gv_, ax, ev_),
            gv, ev.numpy(), out_spec=(jsh.P(), jsh.P()))
        np.testing.assert_allclose(got_m.numpy(), ref_m, rtol=1e-6)
        np.testing.assert_allclose(got_e.numpy(), ref_e, atol=1e-6)
