"""Readings for a cell's limits: the program's sound runs and the control
(the reference in the program's place at a lower precision), several
seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        --jobs 2 --precision bf16|tf32 [--sound-only]

For each seed: the cell's inputs from the seed, ``--jobs`` jobs of the
program (its timed path, no window), then the comparison of those jobs
(``sound``) and of the control's records for the same inputs
(``control``). One JSON line a seed and side, each number compared
beside the cell's limit. The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import numpy as np

from run import ROOT, Cell, Ctx, cache_env, judge


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--precision", required=True, choices=("bf16", "tf32"))
    ap.add_argument("--sound-only", action="store_true")
    args = ap.parse_args(argv)
    cache_env(ROOT)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    cell = Cell(args.workload)
    job = importlib.import_module(f"portbench.jobs.{cell.kind}")
    for seed in args.seeds:
        ctx = Ctx(cell, seed, "cuda")
        state = job.setup(ctx)
        records = [job.run(state, j) for j in range(args.jobs)]
        torch.cuda.synchronize()
        job.release(state)
        torch.cuda.empty_cache()
        sides = [("sound", records)]
        if not args.sound_only:
            t = time.perf_counter()
            ctl = job.control(state, records, args.precision, ctx)
            sides.append(("control", ctl))
            ctl_s = time.perf_counter() - t
        for side, recs in sides:
            t = time.perf_counter()
            values = job.check(state, recs, np.random.default_rng(
                [seed, 1]), ctx)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": side, "precision": args.precision,
                              "check_s": time.perf_counter() - t,
                              "control_s": ctl_s if side == "control"
                              else None,
                              "checks": judge(values, cell.limits)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
