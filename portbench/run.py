"""One run of one benchmark cell of the PyTorch/CUDA port (``repro_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is found by name: its entry in ``BENCHMARK.json``, its file
``portbench/workloads/<cell>.json`` (job kind, traffic, check sizes,
limits), its configuration's file, the job ``portbench/jobs/<kind>.py``
and, with ``--trace 1``, one reader ``portbench/metrics/<metric>.py`` for
each per-layer metric that lists the cell.

A run: set-up (inputs from the seed, the program's kernels built or
loaded, one warm-up job), then a closed loop of one client: jobs back to
back until the first that ends after ``--seconds``; the window is from
its start to that job's end. Then the reference judges what the window
produced, and the last line of standard output is the result (JSON).
Every number that goes into ``correct`` is printed beside its limit,
under ``checks`` there and as the last lines of standard error.

With ``--trace 1`` the program's spans are read over the window and the
device is profiled over its first jobs (``trace_jobs``); the run reports
the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``BANNED``, compared
    whole (``repro_torch`` is not ``repro``)."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in BANNED)


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


class Cell:
    """A cell's entries and files, as ``BENCHMARK.json`` names them."""

    def __init__(self, name: str, root: Path = ROOT, here: Path = HERE):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        entry = {w["name"]: w for w in bench["workloads"]}.get(name)
        if entry is None:
            raise SystemExit(f"portbench: no workload {name!r} in "
                             "BENCHMARK.json")
        self.name = name
        self.chips = int(entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads(
            (root / configs[entry["config"]]["file"]).read_text())
        self.here = here
        self.workload = json.loads(
            (here / "workloads" / f"{name}.json").read_text())
        self.kind = self.workload["job"]
        self.traffic = self.workload["traffic"]
        self.check = self.workload["check"]
        self.limits = self.workload["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def load_reader(name: str, root: Path = HERE):
    """The module ``metrics/<name>.py`` (a name may hold dots)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Ctx:
    """What a job, the reference and a metric reader are given."""

    def __init__(self, cell: Cell, seed: int, device: str):
        self.config = cell.config
        self.traffic = cell.traffic
        self.check = cell.check
        self.seed = int(seed)
        self.device = device
        self.records: list = []
        self.spans: list = []            # (name, seconds) of span_jobs jobs
        self.span_jobs = 0
        self.profile = None              # trace.Profile of the first jobs
        self.probes: dict = {}           # what the readers' probes count
        self.restores: list = []         # undo the probes' wrapping


def judge(values: dict, limits: dict) -> dict:
    """Each compared number beside its limit; a number with no limit, or
    a limit with no number, is an error of the harness."""
    if set(values) != set(limits):
        raise SystemExit(f"portbench: checks {sorted(values)} and limits "
                         f"{sorted(limits)} differ")
    return {k: {"value": float(values[k]), "limit": float(limits[k])}
            for k in limits}


def within(c: dict) -> bool:
    return math.isfinite(c["value"]) and c["value"] <= c["limit"]


def passed(checks: dict) -> bool:
    return all(within(c) for c in checks.values())


def run(name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", cell: Cell | None = None,
        t_process: float = T_PROCESS) -> dict:
    """One run of the cell; returns the result object."""
    import numpy as np
    import torch

    from portbench import trace as ptrace
    cell = cell or Cell(name)
    ctx = Ctx(cell, seed, device)
    job = importlib.import_module(f"portbench.jobs.{cell.kind}")
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    state = job.setup(ctx)
    job.warmup(state)
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    readers = {}
    if trace:
        readers = {m["name"]: load_reader(m["name"], cell.here)
                   for m in cell.per_layer}
        for r in readers.values():
            if hasattr(r, "probe"):
                r.probe(ctx)
    from repro_torch.obs import trace as spans
    if trace:
        spans.enable_profiler_annotations(True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    profiler = ptrace.JobProfiler(ctx, int(cell.workload.get(
        "trace_jobs", 1)) if trace else 0, on_card)
    setup_s = time.perf_counter() - t_process
    t0 = time.perf_counter()
    j = 0
    starts, job_s = [], []
    while True:
        starts.append(time.perf_counter())
        with profiler.job(j):
            ctx.records.append(job.run(state, j))
            sync()
        job_s.append(time.perf_counter() - starts[-1])
        j += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    spans.enable_profiler_annotations(False)
    # the span metrics read the jobs the profiler left alone, where there
    # are such jobs: profiling slows the host's side of a job
    first = profiler.n_jobs if len(starts) > profiler.n_jobs else 0
    ctx.span_jobs = len(starts) - first
    ctx.spans = [(s.name, s.duration) for s in spans.TRACER.spans()
                 if s.t0 >= starts[first] - 1e-9]
    ctx.profile = profiler.result()
    for undo in ctx.restores:
        undo()

    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        for mname, reader in readers.items():
            v = reader.read(ctx)
            if v is not None:
                metrics[mname] = {"value": float(v), "unit": units[mname]}
    else:
        e2e = job.end_to_end(ctx.records, window_s)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            # ``peak_gib`` and its per-cell forms (``peak_gib.<cells>``)
            # are the window's device peak
            v = peak / 2 ** 30 if m["name"].split(".")[0] == "peak_gib" \
                else e2e[m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the reference runs once the window has closed and the program's
    # state is freed
    job.release(state)
    if on_card:
        torch.cuda.empty_cache()
    rng = np.random.default_rng([int(seed), 1])
    values = job.check(state, ctx.records, rng, ctx)
    checks = judge(values, cell.limits)
    ok = passed(checks)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": int(max(peak, setup_peak))}
    if trace and ctx.profile is not None:
        dev["busy_s"] = ctx.profile.busy_s
        dev["window_s"] = ctx.profile.window_s
    out = {"correct": ok, "attempted": len(ctx.records),
           "failed": sum(not within(c) for c in checks.values()),
           "metrics": metrics, "device": dev}
    if trace and ctx.profile is not None:
        out["breakdown"] = ctx.profile.breakdown()
    out["checks"] = checks
    print(f"portbench: {len(job_s)} jobs, seconds {job_s}", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 cell=cell)
    found = banned_modules()
    if found:
        print(f"portbench: modules that may not be loaded: {found}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
