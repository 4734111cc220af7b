"""The port's training launcher (``repro_torch.launch.train``) on the CPU.

* ``--smoke --device cpu`` with checkpoints: the reference's ``done:``
  line, ``step_*`` files, and a run stopped at step 4 and resumed to 6
  equal bit for bit to an uninterrupted 6-step run (each step is a pure
  function of the state and the step's seeded tokens); ``--resume`` past
  ``--steps`` prints the reference's message.
* ``--mesh`` on spawned ``gloo`` worlds (a ``FileStore``, no ports), the
  parameters and Adam state sharded by the plan: ``2x1`` (FSDP over two
  data ranks of two rows each) equal bit for bit to ``1x1 --micro 2``
  (the same gradient sums; the clip's global norm is summed in f64, so
  summing it shard by shard does not move its f32 bits); ``1x2`` (the
  model axis split, Megatron style) and ``2x2`` against ``1x1`` with the
  same flags within rtol 1e-4 on the losses and the sum of the 4 steps'
  learning rates (3e-5) on each parameter (TP splits the row-parallel
  products' sums, so not bit for bit). On every mesh each rank's local parameter and
  Adam bytes equal the plan's arithmetic, and the gathered state is the
  same on every rank.
* The launcher's flags are the reference's plus ``--device``; a model
  that takes embeddings exits with a message; the default device is the
  card, which raises here.
"""
import os
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch import train
from repro_torch.models.convert import train_state_to_numpy
from repro_torch.train import optimizer as topt

SRC = str(Path(__file__).resolve().parents[1] / "src")
WORLD_TIMEOUT = 180
ARGS = ["--arch", "llama3.2-1b", "--smoke", "--batch", "4", "--seq", "24",
        "--device", "cpu"]


def _leaves(state):
    return [np.asarray(x) for x in topt.tree_leaves(
        train_state_to_numpy(state))]


def _bitwise(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.tobytes() == y.tobytes()
        for x, y in zip(a, b))


@pytest.fixture(scope="module")
def plain6():
    return train.main(ARGS + ["--steps", "6"])


def test_smoke_checkpoints_and_resume_bitwise(tmp_path, capsys, plain6):
    ck = str(tmp_path / "ck")
    first = train.main(ARGS + ["--steps", "4", "--ckpt-dir", ck,
                               "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "done: 4 steps in" in out and "loss=" in out
    assert sorted(p.name for p in Path(ck).iterdir()) == [
        f"step_{s:010d}.npz" for s in (0, 2, 4)]
    assert [h["step"] for h in first["history"]] == [0, 1, 2, 3]
    resumed = train.main(ARGS + ["--steps", "6", "--ckpt-dir", ck,
                                 "--ckpt-every", "2", "--resume"])
    assert "done: 6 steps in" in capsys.readouterr().out
    assert [h["step"] for h in resumed["history"]] == [4, 5]
    assert resumed["history"][1]["loss"] == plain6["history"][5]["loss"]
    assert _bitwise(_leaves(resumed["state"]), _leaves(plain6["state"]))
    assert int(resumed["state"].step) == 6
    past = train.main(ARGS + ["--steps", "3", "--ckpt-dir", ck, "--resume"])
    assert "done: already at step 6, no steps to run" in \
        capsys.readouterr().out
    assert past["history"] == [] and past["steps"] == 6


def test_smoke_metrics_finite_with_warmup(plain6):
    """Fresh random tokens every step at a warmup learning rate: the loss
    stays near ln V (the smoke vocabulary's 128) and finite."""
    losses = [h["loss"] for h in plain6["history"]]
    assert np.isfinite(losses).all()
    assert all(abs(x - np.log(128)) < 0.5 for x in losses)
    assert all(h["ms"] > 0 and np.isfinite(h["grad_norm"])
               for h in plain6["history"])
    # warmup: lr = 3e-4 * (step + 1) / 100
    np.testing.assert_allclose([h["lr"] for h in plain6["history"]],
                               [3e-6 * (s + 1) for s in range(6)],
                               rtol=1e-6)


def _child(rank, n, mesh, tmp):
    sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), n),
        rank=rank, world_size=n, timeout=timedelta(seconds=WORLD_TIMEOUT))
    try:
        from repro_torch.launch import train as tr
        from repro_torch.models import sharding_plan as sp
        from repro_torch.models.convert import train_state_to_numpy as tn
        res = tr.main(ARGS + ["--steps", "4", "--mesh", mesh,
                              "--ckpt-dir", os.path.join(tmp, "ck"),
                              "--ckpt-every", "2"])
        st, plan = res["state"], res["plan"]
        full = tn(st)
        torch.save({"history": res["history"], "state": full,
                    "bytes": [sp.local_bytes(t) for t in
                              (st.params, st.opt.m, st.opt.v)],
                    "planned": [sp.planned_bytes(_tensors(t),
                                                 plan.param_specs, plan.mesh)
                                for t in (full.params, full.opt.m,
                                          full.opt.v)]},
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _world(tmp: Path, mesh: str):
    d, m = (int(x) for x in mesh.split("x"))
    n = d * m
    ctx = mp.start_processes(_child, args=(n, mesh, str(tmp)), nprocs=n,
                             join=False, start_method="spawn")
    deadline = time.time() + WORLD_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.time() > deadline:
                raise TimeoutError(f"world {mesh} ran past {WORLD_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module")
def plain4():
    """1x1 runs of 4 steps: the whole batch at once, and in two
    microbatches of two rows (the 2x1 mesh's arithmetic)."""
    return {micro: train.main(ARGS + ["--steps", "4", "--micro", micro])
            for micro in ("1", "2")}


def _np_leaves(tree):
    return [np.asarray(x) for x in topt.tree_leaves(tree)]


def _tensors(tree):
    return topt.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
def test_mesh_against_one_rank(mesh, tmp_path, plain4):
    ranks = _world(tmp_path, mesh)
    for r in ranks:                # each rank holds its plan's shard
        assert r["bytes"] == r["planned"]
    for r in ranks[1:]:            # the gathered state is the same
        assert _bitwise(_np_leaves(r["state"]), _np_leaves(ranks[0]["state"]))
    got, loss = ranks[0]["state"], [h["loss"] for h in ranks[0]["history"]]
    one = plain4["1"]
    if mesh == "2x1":
        # the sum of the two ranks' gradients is the 2-microbatch step's
        two = plain4["2"]
        assert loss == [h["loss"] for h in two["history"]]
        assert _bitwise(_np_leaves(got), _leaves(two["state"]))
    # against the whole batch at once: the same terms in another order,
    # which Adam's first steps (lr · sign of each gradient element) turn
    # into parameter differences of the order of lr
    np.testing.assert_allclose(loss, [h["loss"] for h in one["history"]],
                               rtol=1e-4)
    want = train_state_to_numpy(one["state"]).params
    lr_sum = sum(h["lr"] for h in one["history"])
    for a, b in zip(_np_leaves(got.params), _np_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=lr_sum)
    # rank 0 wrote the checkpoints
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        f"step_{s:010d}.npz" for s in (0, 2, 4)]


def test_flags_equal_reference_plus_device():
    from repro.launch import train as jtrain

    def opts(parser):
        return {tuple(a.option_strings): (a.dest, a.default, a.type,
                                          a.required)
                for a in parser._actions}
    port = opts(train.build_parser())
    assert port.pop(("--device",))[:2] == ("device", "cuda")
    assert port == opts(jtrain.build_parser())


def test_refusals():
    with pytest.raises(SystemExit, match="takes embeddings"):
        train.main(["--arch", "qwen2-vl-2b", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="takes embeddings"):
        train.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train.main(ARGS + ["--resume"])            # needs --ckpt-dir
    with pytest.raises(SystemExit):
        train.main(ARGS + ["--micro", "3"])        # 4 rows in 3 slices
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])
