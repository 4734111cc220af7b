"""The sharded training step (``make_train_step(shard_fns=plan)``, the
state placed by ``models/sharding_plan``) on a spawned ``gloo`` world of
2 x 2 CPU ranks (data x model, one world for the module, a ``FileStore``):

* against the reference: one f32 step (2 microbatches, AdamW lr 1e-3) of
  each family's smoke config (dense llama3.2-1b, MoE kimi-k2, SSM
  mamba2-130m, hybrid jamba, VLM qwen2-vl with ``pos3``, audio hubert)
  from the reference's initial state (``convert.train_state_from_jax``),
  held against the reference's jitted step at f32 compute: the loss
  within 1e-5 relative, each leaf of the new parameters and Adam moments
  within 2e-5 of its norm (plus 1e-7), PR 24's bounds for the unsharded
  step;
* each rank's local bytes of the parameters and of m and v equal the
  plan's arithmetic (``planned_bytes``), and the gathered state is equal
  on every rank, bit for bit;
* elastic restore: the state saved on 2 x 2 (full arrays, rank 0 writes)
  restores on 4 x 1 (the same world, another mesh) and on one process
  without a mesh to the saved arrays bit for bit.
"""
import functools
import os
import sys
import time
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jt
from repro.train import train_step as jts
from repro.train.optimizer import AdamWConfig as JAdamW

SRC = str(Path(__file__).resolve().parents[1] / "src")
WORLD_TIMEOUT = 240
FAMILIES = ["llama3.2-1b", "kimi-k2-1t-a32b", "mamba2-130m",
            "jamba-1.5-large-398b", "qwen2-vl-2b", "hubert-xlarge"]
B, S, MICRO, LR = 4, 32, 2, 1e-3
LOSS_RTOL, LEAF_RTOL, LEAF_ATOL = 1e-5, 2e-5, 1e-7


def _reference(arch):
    """The reference's initial state and its f32 step's state and loss
    (numpy leaves)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_train_step import make_batch
    jcfg = j_get_arch(arch).smoke
    batch = make_batch(jcfg, seed=2, b=B, s=S)
    state = jts.init_state(jcfg, jax.random.PRNGKey(0))
    f32 = functools.partial(jt.apply_model, compute_dtype=jnp.float32)
    orig = jts.apply_model
    jts.apply_model = f32
    try:
        step = jax.jit(jts.make_train_step(jcfg, JAdamW(lr=LR),
                                           microbatches=MICRO))
        new, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jts.apply_model = orig
    to_np = functools.partial(jax.tree.map, np.asarray)
    return {"state": to_np(state), "new": to_np(new),
            "loss": float(m["loss"]), "batch": batch}


def _job_families(mesh, tmp):
    from repro_torch.configs import get_arch
    from repro_torch.models import sharding_plan as sp
    from repro_torch.models.convert import (train_state_from_jax,
                                            train_state_to_numpy)
    from repro_torch.train.optimizer import AdamWConfig, OptState
    from repro_torch.train.train_step import TrainState, make_train_step
    ref = torch.load(os.path.join(tmp, "ref.pt"), weights_only=False)
    out = {}
    for arch in FAMILIES:
        cfg = get_arch(arch).smoke
        state = train_state_from_jax(ref[arch]["state"], cfg, "cpu")
        plan = sp.plan_for(cfg, mesh, B, state.params)
        specs = plan.param_specs
        st = plan.sharding(TrainState(specs, OptState(specs, specs, None),
                                      None))(state)
        batch = {k: torch.from_numpy(np.array(v))
                 for k, v in ref[arch]["batch"].items()}
        bsh = plan.sharding(sp.batch_pspecs(cfg, "train", B, mesh, batch))
        step = make_train_step(cfg, AdamWConfig(lr=LR), microbatches=MICRO,
                               shard_fns=plan.shard_fns,
                               grad_shardings=plan.sharding(specs),
                               compute_dtype=torch.float32)
        new, m = step(st, bsh(batch))
        out[arch] = {"state": train_state_to_numpy(new),
                     "loss": float(m["loss"]),
                     "bytes": [sp.local_bytes(t) for t in
                               (new.params, new.opt.m, new.opt.v)],
                     "planned": [sp.planned_bytes(t, specs, mesh) for t in
                                 (state.params, state.opt.m, state.opt.v)]}
        if arch == FAMILIES[0]:
            _job_checkpoint(tmp, mesh, new, out)
    return out


def _job_checkpoint(tmp, mesh, state, out):
    """Save the sharded state, then restore it on a 4 x 1 mesh of the
    same ranks."""
    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import sharding_plan as sp
    from repro_torch.models.convert import train_state_to_numpy
    from repro_torch.train.optimizer import OptState, tree_map
    from repro_torch.train.train_step import TrainState
    CheckpointManager(os.path.join(tmp, "ck"), mesh=mesh).save(1, state)
    mesh41 = make_local_mesh((4, 1), device="cpu")
    full = train_state_to_numpy(state)
    specs = sp.params_pspecs(full.params, mesh41)
    sh = sp.Shardings(mesh41, TrainState(specs, OptState(specs, specs, None),
                                         None))
    like = tree_map(lambda a: torch.from_numpy(np.array(a)), full)
    got, step = CheckpointManager(os.path.join(tmp, "ck"),
                                  mesh=mesh41).restore(like, shardings=sh)
    out["restore41"] = {"step": step, "state": train_state_to_numpy(got),
                        "bytes": sp.local_bytes(got.params),
                        "planned": sp.planned_bytes(like.params, specs,
                                                    mesh41)}


def _child(rank, n, tmp):
    sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), n),
        rank=rank, world_size=n, timeout=timedelta(seconds=WORLD_TIMEOUT))
    try:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh((2, 2), device="cpu")
        torch.save(_job_families(mesh, tmp),
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    ref = {arch: _reference(arch) for arch in FAMILIES}
    torch.save(ref, tmp / "ref.pt")
    ctx = mp.start_processes(_child, args=(4, str(tmp)), nprocs=4,
                             join=False, start_method="spawn")
    deadline = time.time() + WORLD_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.time() > deadline:
                raise TimeoutError(f"world ran past {WORLD_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return tmp, ref, ranks


def _leaves(tree):
    from repro_torch.train import optimizer as topt
    return [np.asarray(x) for x in topt.tree_leaves(tree)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_step_matches_reference(world, arch):
    from repro_torch.configs import get_arch
    from repro_torch.models.convert import train_state_from_jax
    from repro_torch.models.convert import train_state_to_numpy as tn
    _, ref, ranks = world
    got = ranks[0][arch]
    np.testing.assert_allclose(got["loss"], ref[arch]["loss"],
                               rtol=LOSS_RTOL)
    want = tn(train_state_from_jax(ref[arch]["new"], get_arch(arch).smoke,
                                   "cpu"))
    for part in ("params", "opt"):
        a = _leaves(getattr(got["state"], part))
        b = _leaves(getattr(want, part))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            err = float(np.linalg.norm((x - y).ravel()))
            assert err <= LEAF_RTOL * float(np.linalg.norm(y.ravel())) + \
                LEAF_ATOL, (arch, part, x.shape, err)


def test_rank_bytes_are_the_plans_and_gathers_agree(world):
    _, _, ranks = world
    for arch in FAMILIES:
        for r in ranks:
            assert r[arch]["bytes"] == r[arch]["planned"], arch
        first = _leaves(ranks[0][arch]["state"])
        for r in ranks[1:]:
            assert all(x.tobytes() == y.tobytes() for x, y in
                       zip(first, _leaves(r[arch]["state"])))


def test_elastic_restore_is_exact(world):
    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.models.convert import train_state_to_numpy
    from repro_torch.train.optimizer import tree_map
    tmp, _, ranks = world
    saved = _leaves(ranks[0][FAMILIES[0]]["state"])
    with np.load(tmp / "ck" / "step_0000000001.npz") as z:
        files = [z[f"leaf_{i}"] for i in range(len(z.files))]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(files, saved))
    for r in ranks:
        got = r["restore41"]
        assert got["step"] == 1 and got["bytes"] == got["planned"]
        assert all(a.tobytes() == b.tobytes() for a, b in
                   zip(_leaves(got["state"]), saved))
    like = tree_map(lambda a: torch.from_numpy(np.array(a)),
                    ranks[0][FAMILIES[0]]["state"])
    one, step = CheckpointManager(tmp / "ck").restore(like)
    assert step == 1
    assert all(a.tobytes() == b.tobytes() for a, b in
               zip(_leaves(train_state_to_numpy(one)), saved))
