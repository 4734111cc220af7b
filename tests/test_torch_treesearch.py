"""Port parity: the multi-start tree search, its checkpoints and its replay
loop.

The same numpy inputs go through ``repro.phylo.treesearch`` /
``repro.dist.{checkpoint,fault}`` and their ``repro_torch`` counterparts
(on the CPU). Exact: postorders, normalized and random-addition trees,
fleet starts, NNI and SPR candidates, checkpoint files. The fleet: the
same ``best_start`` and move counts, final logL within 1e-4 * |logL|.
Within the port, StepFailure replay and kill-and-resume are bit-identical
to the uninterrupted run, and a fleet checkpoint the JAX package wrote
resumes and finishes in the port.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import treeio as jtreeio
from repro.core.alphabet import DNA
from repro.core.msa import MSAConfig, center_star_msa
from repro.data import SimConfig, simulate_family
from repro.dist import checkpoint as jckpt
from repro.phylo import ml as jml
from repro.phylo import models as jmodels
from repro.phylo import treesearch as jts
from repro_torch.dist import checkpoint as tckpt
from repro_torch.dist import fault as tfault
from repro_torch.phylo import treesearch as tts
from test_torch_msa_run import one_torch_thread  # noqa: F401

BASE = dict(gap_code=DNA.gap_code, starts=3, spr_radius=2, rounds=3,
            model="jc69", steps=30, seed=0)


@pytest.fixture(scope="module")
def msa8():
    fam = simulate_family(SimConfig(n_leaves=8, root_len=120, seed=1))
    return np.asarray(center_star_msa(fam.seqs,
                                      MSAConfig(method="kmer")).msa)


@pytest.fixture(scope="module")
def searches(msa8):
    return (jts.TreeSearcher(**BASE).search(msa8),
            tts.TreeSearcher(device="cpu", **BASE).search(msa8))


def _newick(res):
    return jtreeio.to_newick(res.children, res.blen, res.root)


def _same(a, b):
    assert _newick(a).encode() == _newick(b).encode()
    assert a.logl_final == b.logl_final
    assert np.array_equal(a.trajectories, b.trajectories, equal_nan=True)
    assert np.array_equal(a.n_moves, b.n_moves)


def _trees(n, seeds):
    """Index-topological random trees and NNI-shuffled (not by id) ones."""
    out = []
    for s in seeds:
        rng = np.random.default_rng(s)
        ch, bl, rt = jts.random_addition_tree(n, rng)
        bl = rng.random(bl.shape).astype(np.float32)
        order = np.arange(n, 2 * n - 1)
        out.append((ch, bl, order))
        cands = jml.nni_candidates(ch, bl, order, n)
        k = int(rng.integers(cands[0].shape[0]))
        out.append((cands[0][k], cands[1][k], cands[2][k]))
    return out


@pytest.mark.parametrize("n", [5, 12, 23])
def test_trees_and_orders_exact(n):
    for seed in range(4):
        a = jts.random_addition_tree(n, np.random.default_rng((seed, 2)))
        b = tts.random_addition_tree(n, np.random.default_rng((seed, 2)))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for ch, bl, order in _trees(n, range(3)):
        root = int(order[-1])
        np.testing.assert_array_equal(tts.topological_order(ch, root, n),
                                      jts.topological_order(ch, root, n))
        for x, y in zip(tts.normalize_tree(ch, bl, root, n),
                        jts.normalize_tree(ch, bl, root, n)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("radius", [1, 2, 3, 50])
def test_spr_candidates_exact(radius):
    for n in (4, 9, 17):
        for ch, bl, order in _trees(n, range(3)):
            a = jts.spr_candidates(ch, bl, order, n, radius)
            b = tts.spr_candidates(ch, bl, order, n, radius)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_fleet_starts_exact(msa8):
    kw = dict(k=4, gap_code=DNA.gap_code, n_chars=DNA.n_chars, seed=3)
    sj, lj = jts.fleet_starts(msa8, **kw)
    st, lt = tts.fleet_starts(msa8, device="cpu", **kw)
    assert lt == lj == ("nj", "cluster", "random2", "random3")
    for (cj, bj, rj), (ct, bt, rt) in zip(sj, st):
        assert rt == rj == 14
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_allclose(bt, bj, rtol=1e-5, atol=1e-6)


def test_score_fleet_matches_reference(msa8):
    from repro.core import likelihood as jlik
    n = msa8.shape[0]
    pat, w = jlik.compress_patterns(msa8)
    trees = _trees(n, range(2))
    K = 2
    blocks = [jml.nni_candidates(*trees[2 * k], n) for k in range(K)]
    C = max(b[0].shape[0] for b in blocks)
    ch = np.stack([np.concatenate([b[0], b[0][:C - b[0].shape[0]]])
                   for b in blocks])
    bl = np.stack([np.concatenate([b[1], b[1][:C - b[1].shape[0]]])
                   for b in blocks]) + 1e-3
    od = np.stack([np.concatenate([b[2], b[2][:C - b[2].shape[0]]])
                   for b in blocks])
    prm = np.stack([jmodels.init_params("hky85"),
                    jmodels.init_params("hky85") + 0.3]).astype(np.float32)
    ref = np.asarray(jts.score_fleet(
        jnp.asarray(pat), jnp.asarray(w), jnp.asarray(ch), jnp.asarray(bl),
        jnp.asarray(od), jnp.asarray(prm), model="hky85", site_chunk=32))
    out = tts.score_fleet(torch.from_numpy(pat), torch.from_numpy(w), ch, bl,
                          od, prm, model="hky85", site_chunk=32)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    part = tts.score_fleet(torch.from_numpy(pat), torch.from_numpy(w), ch,
                           bl, od, prm, model="hky85", site_chunk=32,
                           n_cand=np.array([3, C]), budget=1)
    assert np.isneginf(part[0, 3:]).all()
    np.testing.assert_allclose(part[0, :3], out[0, :3], rtol=1e-6)
    np.testing.assert_allclose(part[1], out[1], rtol=1e-6)


def test_search_matches_reference(searches):
    ref, out = searches
    assert out.start_labels == ref.start_labels
    assert out.model == ref.model
    assert out.best_start == ref.best_start
    np.testing.assert_array_equal(out.n_moves, ref.n_moves)
    assert out.n_moves.sum() > 0
    np.testing.assert_allclose(out.logl_init, ref.logl_init, rtol=1e-5)
    tol = 1e-4 * abs(ref.logl_final)
    assert abs(out.logl_final - ref.logl_final) <= tol
    np.testing.assert_allclose(out.trajectories, ref.trajectories,
                               rtol=1e-4)
    assert jtreeio.bipartitions(out.children, out.root, 8) == \
        jtreeio.bipartitions(ref.children, ref.root, 8)


def test_step_failure_replay_bit_identical(msa8, searches, tmp_path):
    clean = searches[1]

    class Once:
        fired = False

        def __call__(self, step):
            if step == 2 and not self.fired:
                self.fired = True
                raise tfault.StepFailure("injected at round 2")

    faulty = tts.TreeSearcher(ckpt_dir=str(tmp_path), failure_hook=Once(),
                              device="cpu", **BASE).search(msa8)
    _same(clean, faulty)


def test_kill_and_resume_bit_identical(msa8, searches, tmp_path):
    clean = searches[1]

    def kill(step):
        if step == 2:
            raise RuntimeError("killed")

    with pytest.raises(RuntimeError, match="killed"):
        tts.TreeSearcher(ckpt_dir=str(tmp_path), failure_hook=kill,
                         device="cpu", **BASE).search(msa8)
    assert tckpt.CheckpointManager(tmp_path).all_steps() == [0, 1, 2]
    resumed = tts.TreeSearcher(ckpt_dir=str(tmp_path), resume=True,
                               device="cpu", **BASE).search(msa8)
    _same(clean, resumed)


def test_jax_checkpoint_resumes_in_the_port(msa8, searches, tmp_path):
    """The JAX fleet is killed after round 1; the port restores its
    newest checkpoint (the reference's file layout) and finishes."""
    ref = searches[0]

    def kill(step):
        if step == 2:
            raise RuntimeError("killed")

    with pytest.raises(RuntimeError, match="killed"):
        jts.TreeSearcher(ckpt_dir=str(tmp_path), failure_hook=kill,
                         **BASE).search(msa8)
    with np.load(tmp_path / "step_0000000002.npz") as z:
        saved_traj = z["leaf_8"]
    out = tts.TreeSearcher(ckpt_dir=str(tmp_path), resume=True,
                           device="cpu", **BASE).search(msa8)
    # rounds 0-1 come from the JAX file bit for bit
    np.testing.assert_array_equal(out.trajectories[:, :2], saved_traj[:, :2])
    np.testing.assert_array_equal(out.n_moves, ref.n_moves)
    assert out.best_start == ref.best_start
    assert abs(out.logl_final - ref.logl_final) <= 1e-4 * abs(ref.logl_final)


def test_checkpoint_files_cross_load(tmp_path):
    state = {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
             "a": np.int32(7), "c": [np.ones(2, np.int8), np.zeros(1)]}
    jckpt.CheckpointManager(tmp_path / "j").save(5, state)
    tm = tckpt.CheckpointManager(tmp_path / "j", keep=2)
    got, step = tm.restore(state)
    assert step == 5 and set(got) == {"a", "b", "c"}
    np.testing.assert_array_equal(got["b"], state["b"])
    np.testing.assert_array_equal(got["c"][0], state["c"][0])
    for s in (6, 7, 8):
        tm.save(s, dict(state, a=np.int32(s)))
    assert tm.all_steps() == [7, 8]
    (tmp_path / "j" / "step_0000000008.npz").write_bytes(b"corrupt")
    with pytest.warns(UserWarning, match="unreadable"):
        got, step = tm.restore(state)
    assert step == 7 and int(got["a"]) == 7
    jgot, jstep = jckpt.CheckpointManager(tmp_path / "j").restore(
        state, step=7)
    np.testing.assert_array_equal(np.asarray(jgot["b"]), state["b"])
    assert int(jgot["a"]) == 7
    like = {"t": torch.zeros(2, 3), "n": np.zeros(2, np.int8)}
    tm.save(9, {"t": torch.ones(2, 3), "n": np.ones(2, np.int8)})
    got, _ = tm.restore(like)
    assert isinstance(got["t"], torch.Tensor) and got["t"].sum() == 6


def test_resilient_loop_replays_and_gives_up(tmp_path):
    calls = []

    class Steps:
        n_steps = 5

        def __call__(self, step):
            return step

    def step_fn(state, batch):
        calls.append(batch)
        return {"x": state["x"] + batch}

    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise tfault.StepFailure("once")

    ck = tckpt.CheckpointManager(tmp_path / "a")
    loop = tfault.ResilientLoop(step_fn, ck, ckpt_every=2, failure_hook=hook)
    state, n = loop.run({"x": np.int64(0)}, Steps())
    assert n == 5 and int(state["x"]) == 10
    assert calls == [0, 1, 2, 2, 3, 4]           # replayed from step 2

    def always(step):
        raise tfault.StepFailure("always")

    with pytest.raises(tfault.StepFailure):
        tfault.ResilientLoop(step_fn, tckpt.CheckpointManager(tmp_path / "b"),
                             ckpt_every=1, failure_hook=always,
                             max_failures=2).run({"x": np.int64(0)}, Steps())


def test_searcher_validation(msa8):
    """A mesh is ported: in a world of one the fleet's scoring over it
    gives the fleet of one process, bit for bit."""
    from repro_torch.launch import mesh as lm
    kw = dict(BASE, rounds=1, steps=5, device="cpu")
    with lm.world("cpu"):
        got = tts.TreeSearcher(mesh=lm.mesh_from_arg(None, device="cpu"),
                               **kw).search(msa8)
    _same(got, tts.TreeSearcher(**kw).search(msa8))
    with pytest.raises(ValueError, match="at least one start"):
        tts.TreeSearcher(gap_code=5, starts=0)


def test_entry_points_default_to_the_card(msa8, monkeypatch):
    """With no device given, ``fleet_starts`` runs on a tensor msa's own
    device and otherwise on the card, as does ``pruning_log_likelihood``
    on host inputs: without a card both raise instead of running on the
    CPU."""
    from repro_torch.core import likelihood as tlik
    from repro_torch.phylo import models as tmodels
    kw = dict(k=3, gap_code=DNA.gap_code, n_chars=DNA.n_chars, seed=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tts.fleet_starts(msa8, **kw)
    with pytest.raises(RuntimeError, match="cuda"):
        tts.TreeSearcher(gap_code=DNA.gap_code).search(msa8)
    on_cpu, _ = tts.fleet_starts(torch.from_numpy(msa8), **kw)
    asked, _ = tts.fleet_starts(msa8, device="cpu", **kw)
    for a, b in zip(on_cpu, asked):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ch, bl, rt = asked[0]
    pat, w = tlik.compress_patterns(msa8)
    dec = tmodels.decompose("jc69", np.zeros(0, np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        tlik.pruning_log_likelihood(pat, w, ch, bl, np.arange(8, 15), rt,
                                    *dec)


@pytest.mark.parametrize("extra", [[], ["--bootstrap", "6"]])
def test_tree_run_search_cli_resumes(msa8, tmp_path, extra):
    """``tree_run --refine search --restartable``, then ``--resume`` from
    the same checkpoints, against the JAX CLI's report and tree."""
    from repro.launch import tree_run as jrun
    from repro_torch.launch import tree_run as trun
    fa = tmp_path / "aligned.fasta"
    fa.write_text("".join(f">s{i}\n{DNA.decode(row)}\n"
                          for i, row in enumerate(msa8)))
    common = ["--fasta", str(fa), "--refine", "search", "--model", "jc69",
              "--starts", "3", "--spr-radius", "2", "--search-rounds", "2",
              "--ml-steps", "30", "--restartable", *extra]
    jrun.main([*common, "--out", str(tmp_path / "jax")])
    trun.main([*common, "--out", str(tmp_path / "torch"), "--device", "cpu"])
    trun.main([*common, "--out", str(tmp_path / "torch"), "--device", "cpu",
               "--resume"])
    ref = json.loads((tmp_path / "jax" / "report.json").read_text())
    out = json.loads((tmp_path / "torch" / "report.json").read_text())
    assert set(out) == set(ref)
    assert out["backend"] == ref["backend"] == "dense+search"
    for key in ("best_start", "start_labels", "n_moves", "starts",
                "spr_radius"):
        assert out["search"][key] == ref["search"][key]
    assert out["model"] == ref["model"] and out["n_nni"] == ref["n_nni"]
    assert out["search"]["ckpt_dir"] == str(tmp_path / "torch" /
                                            "search_ckpt")
    assert abs(out["logl"]["final"] - ref["logl"]["final"]) <= \
        1e-4 * abs(ref["logl"]["final"])
    nwk = (tmp_path / "torch" / "tree.nwk").read_text()
    if extra:
        sup = out["bootstrap"]
        assert sup["replicates"] == 6
        assert 0.0 <= sup["mean_support"] <= 1.0
        assert ")0." in nwk or ")1" in nwk          # support labels
