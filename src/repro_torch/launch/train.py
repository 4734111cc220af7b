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
group the caller initialized): each rank takes rows ``[d·B/D, (d+1)·B/D)``
of every global batch, d its data index; one all-reduce over the world
averages the gradients (and the loss) over the data axis before the
update; the M ranks of a data index run replicated, and rank 0 writes the
checkpoints. Parameters and optimizer state are not sharded (ROADMAP.md
§3).
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
                         "many ranks)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint in --ckpt-dir first")
    ap.add_argument("--device", default="cuda",
                    help="run on the card (default; raises without one) "
                         "or on the plain PyTorch path on the CPU")
    return ap


def batch_for(step: int, batch: int, seq: int, vocab: int, device, *,
              rows=None):
    """Step ``step``'s tokens (labels = tokens) from a generator seeded
    ``step``; ``rows`` (a slice) keeps a rank's rows of the global
    batch."""
    g = torch.Generator(device=device).manual_seed(step)
    toks = torch.randint(0, vocab, (batch, seq), generator=g, device=device)
    if rows is not None:
        toks = toks[rows]
    return {"tokens": toks, "labels": toks}


def main(argv=None):
    """Train; returns ``{"steps", "history", "state"}``: the steps done,
    one ``{"step", "ms", "loss", "aux", "grad_norm", "lr"}`` a step run
    (``ms`` on the host clock around the step, which ends in a device
    sync) and the final ``TrainState``."""
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
    from ..train.optimizer import AdamWConfig
    from ..train.train_step import init_state, make_train_step

    rows, hook = None, None
    if mesh is not None:
        d = mesh.axis_sizes["data"]
        per = args.batch // d
        b = mesh.block_index("data")
        rows = slice(b * per, (b + 1) * per)

        def hook(grads, sums):
            """The data axis's mean: one all-reduce over the world (the
            model axis's replicas add the same terms M times)."""
            if mesh.size == 1:
                return
            for g in grads:
                dist.all_reduce(g, group=mesh.group)
                g.div_(mesh.size)
            for k in sums:
                t = torch.as_tensor(sums[k], dtype=torch.float32,
                                    device=dev).clone()
                dist.all_reduce(t, group=mesh.group)
                sums[k] = t / mesh.size

    step_fn = make_train_step(cfg, AdamWConfig(lr=args.lr),
                              microbatches=args.micro, grad_hook=hook)
    state = init_state(cfg, 0, device=dev)
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
        return batch_for(step, args.batch, args.seq, cfg.vocab_size, dev,
                         rows=rows)

    t0 = time.time()
    if args.ckpt_dir:
        cm = CheckpointManager(args.ckpt_dir, keep=3, mesh=mesh)
        loop = ResilientLoop(step_and_log, cm, ckpt_every=args.ckpt_every)

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
    out = {"steps": steps, "history": history, "state": state}
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
