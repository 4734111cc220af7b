"""LM training launcher on PyTorch: microbatched steps, checkpoints and
failure replay; the port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 100 --batch 8 --seq 128 --ckpt-dir ckpt/ [--smoke] \
      [--resume] [--device cuda|cpu]

Flags:
  --arch          reference architecture name (repro_torch.configs registry)
  --steps         optimizer steps to run
  --batch/--seq   global batch size / sequence length
  --micro         microbatch count (gradient accumulation)
  --lr            AdamW learning rate
  --ckpt-dir      checkpoint directory (atomic step checkpoints)
  --ckpt-every    save cadence in steps
  --smoke         reduced smoke config (CPU-friendly)
  --mesh          data x model ranks of a torch.distributed world, e.g. 2x1
  --resume        restore the newest checkpoint in --ckpt-dir first
  --device        the card (``cuda``, the default; raises without one) or
                  the plain PyTorch path (``cpu``)

The weights are random f32 master weights from a ``torch.Generator``
seeded 0 (``train_step.init_state``), step s's tokens random from one
seeded s: other numbers than the reference's ``PRNGKey`` streams
(ROADMAP.md §3). A model that takes embeddings (qwen2-vl-2b,
hubert-xlarge) exits: this launcher makes tokens only, and the
reference's dies on such a model; ``train_step`` takes their embeddings.

``--mesh DxM`` runs on a world of D·M ranks (``torchrun``, or a process
group the caller initialized) with the reference's plan
(``models/sharding_plan``): the full state is made from the seeded
generator on every rank (the same weights as ``1x1``), then each rank
keeps its shard of every parameter and of Adam's m and v (FSDP over the
data axis, Megatron's split over the model axis; the step count and
step replicated), takes rows ``[d·B/D, (d+1)·B/D)`` of every global batch,
d its data index, and runs the sharded step (``train_step``): the
gradients come back reduce-scattered into the parameters' placements,
so no all-reduce of the gradients follows. Checkpoints hold the full
arrays (gathered, written by rank 0), so a run restores on another mesh
shape. A world of ``gloo`` ranks sharing the card routes the collectives
through gloo's own (``sharding_plan.collectives``), and says so.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch
import torch.distributed as dist


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.train",
        description="LM training with checkpoints and failure replay "
                    "(PyTorch/CUDA port)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--mesh", default="1x1",
                    help="data x model, e.g. 4x2 (needs a world of that "
                         "many ranks): parameters and Adam state sharded "
                         "by the plan, FSDP over data x TP over model")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint in --ckpt-dir first")
    ap.add_argument("--device", default="cuda",
                    help="run on the card (default; raises without one) "
                         "or on the plain PyTorch path on the CPU")
    return ap


def batch_for(step: int, batch: int, seq: int, vocab: int, device):
    """Step ``step``'s tokens (labels = tokens) from a generator seeded
    ``step``."""
    g = torch.Generator(device=device).manual_seed(step)
    toks = torch.randint(0, vocab, (batch, seq), generator=g, device=device)
    return {"tokens": toks, "labels": toks}


def main(argv=None):
    """Train; returns ``{"steps", "history", "state", "plan"}``: the steps
    done, one ``{"step", "ms", "loss", "aux", "grad_norm", "lr"}`` a step
    run (``ms`` on the host clock around the step, which ends in a device
    sync), the final ``TrainState`` (DTensor leaves on a mesh) and the
    mesh's ``sharding_plan.Plan`` (None without one)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    try:
        d, m = (int(x) for x in args.mesh.split("x"))
    except ValueError:
        ap.error(f"--mesh expects DxM (e.g. 4x1), got {args.mesh!r}")

    from ..configs import get_arch

    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    if not cfg.embed_input:
        raise SystemExit(f"{args.arch} takes embeddings (embed_input=False), "
                         "which this launcher does not make; drive it "
                         "through train.train_step with batch['embeds']")
    if args.batch % d or (args.batch // d) % args.micro:
        ap.error(f"--batch {args.batch} must split into {d} data ranks of "
                 f"{args.micro} microbatches")

    from ..device import resolve_device
    from . import mesh as mesh_mod

    dev = resolve_device(args.device)
    with contextlib.ExitStack() as stack:
        mesh = None
        if d * m > 1 or dist.is_initialized():
            stack.enter_context(mesh_mod.world(dev))
            mesh = mesh_mod.make_local_mesh((d, m), device=dev)
            dev = mesh.device
        return _train(args, cfg, dev, mesh)


def _train(args, cfg, dev, mesh):
    from ..device import sync
    from ..dist.checkpoint import CheckpointManager
    from ..dist.fault import ResilientLoop
    from ..models import sharding_plan as sp
    from ..train.optimizer import AdamWConfig, OptState
    from ..train.train_step import TrainState, init_state, make_train_step

    state = init_state(cfg, 0, device=dev)
    shard_fns = psh = state_sh = bsh = plan = None
    route = contextlib.nullcontext()
    if mesh is not None:
        plan = sp.plan_for(cfg, mesh, args.batch, state.params)
        specs = plan.param_specs
        psh = plan.sharding(specs)
        state_sh = plan.sharding(TrainState(specs, OptState(specs, specs,
                                                            None), None))
        state = state_sh(state)         # each rank keeps its shard
        shard_fns = plan.shard_fns
        shape = torch.empty((args.batch, args.seq), device="meta")
        bsh = plan.sharding(sp.batch_pspecs(
            cfg, "train", args.batch, mesh, {"tokens": shape,
                                             "labels": shape}))
        route = sp.collectives(mesh)
        if route.route != "functional":
            print(f"collectives: {route.route} (gloo on {dev.type})")

    step_fn = make_train_step(cfg, AdamWConfig(lr=args.lr),
                              microbatches=args.micro, shard_fns=shard_fns,
                              grad_shardings=psh)
    history = []

    def step_and_log(st, batch):
        sync(dev)
        t0 = time.perf_counter()
        st, metrics = step_fn(st, batch)
        row = {k: float(v) for k, v in metrics.items()}
        sync(dev)
        history.append({"step": int(st.step) - 1,
                        "ms": (time.perf_counter() - t0) * 1e3, **row})
        return st

    def batches(step):
        b = batch_for(step, args.batch, args.seq, cfg.vocab_size, dev)
        return b if bsh is None else bsh(b)

    t0 = time.time()
    with route:
        if args.ckpt_dir:
            cm = CheckpointManager(args.ckpt_dir, keep=3, mesh=mesh)
            loop = ResilientLoop(step_and_log, cm,
                                 ckpt_every=args.ckpt_every,
                                 state_shardings=state_sh)

            class B:
                n_steps = args.steps

                def __call__(self, s):
                    return batches(s)
            state, steps = loop.run(state, B(), resume=args.resume)
        else:
            for s in range(args.steps):
                state = step_and_log(state, batches(s))
            steps = args.steps
    dt = time.time() - t0
    out = {"steps": steps, "history": history, "state": state,
           "plan": plan if mesh is not None else None}
    if not history:             # --resume past --steps: nothing left to run
        print(f"done: already at step {steps}, no steps to run")
        return out
    last = history[-1]
    print(f"done: {steps} steps in {dt:.1f}s "
          f"({dt / max(steps, 1) * 1e3:.0f} ms/step) loss={last['loss']:.4f} "
          f"grad_norm={last['grad_norm']:.3f}")
    return out


if __name__ == "__main__":
    main()
