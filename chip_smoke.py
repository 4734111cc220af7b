#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. print the card's name and power limit (nvidia-smi);
  2. build both CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each,
     started together) and print the build seconds;
  3. hold the Gotoh forward kernel bit-exact against its plain PyTorch
     version, global and local, at the segment shape (B=16384, 64x64),
     the fallback shape (B=64, 2048x1460, broadcast target) and a ragged
     batch with lengths 0 and 1;
  4. hold the match/valid kernel exact against its plain version at
     N=4096, L=1600 and at a ragged N=257, M=130, L=33;
  5. run the main path, ``repro_torch.launch.msa_run`` with default flags
     (``--method kmer --tree nj``), on a 4,096-sequence family simulated
     with the paper's Phi_RNA (16S rRNA) parameters, check its outputs and
     that both kernels were launched during the run;
  6. at every shape the main path gave each kernel (kernel 1 in both
     roles), hold the kernel bit-exact against its plain version again and
     time it beside that plain version, one PyTorch library call where
     there is one, and its bound; print them as one JSON line.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_SEQS = 4096
# H100 SXM peak rates: HBM, f32 outside the tensor
# cores, int8 tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
# f32 operations per DP cell of the Gotoh forward: 3 max + 2 compare for
# h and its argmax, add + compare + 2 select (local) for M, 2 sub + max +
# compare for Ix, add + max (scan) + 2 sub for Iy, 2 sub + compare for dirIy
SW_OPS_PER_CELL = 20


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(fn, reps: int = 3):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, from CUDA events, and the last run's result."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = None
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, out


# ------------------------------------------------------------------ kernel 1

def sw_inputs(B, n, m, *, seed, broadcast=False, ragged=False):
    import torch
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, (B, n)).astype(np.int8)
    b = rng.integers(0, 5, (1 if broadcast else B, m)).astype(np.int8)
    la = rng.integers(max(n // 2, 0), n + 1, B)
    lb = rng.integers(max(m // 2, 0), m + 1, B)
    if ragged:
        la[: B // 2] = rng.integers(0, 2, B // 2)
        lb[B // 4: 3 * B // 4] = rng.integers(0, 2, B // 2)
    lens = np.stack([la, lb], 1).astype(np.int32)
    dev = torch.device("cuda")
    bt = torch.from_numpy(b).to(dev)
    if broadcast:
        bt = bt.expand(B, m)
    return (torch.from_numpy(a).to(dev), bt, torch.from_numpy(lens).to(dev))


def same_sw(k, plain, where: str) -> float:
    """Hold the kernel's ``ForwardResult`` against the plain version's
    ``(dir rows 1..n, rec)``: raises on any differing byte or record field,
    returns the largest score difference."""
    import torch
    from repro_torch.core.pairwise import boundary_row
    rows, rec = plain
    m = rows.shape[2] - 1
    pairs = (("dirs row 0", k.dirs[:, 0],
              boundary_row(m, rows.device).expand(rows.shape[0], m + 1)),
             ("dirs", k.dirs[:, 1:], rows), ("score", k.score, rec[:, 0]),
             ("start_i", k.start_i, rec[:, 1].to(torch.int32)),
             ("start_j", k.start_j, rec[:, 2].to(torch.int32)),
             ("start_state", k.start_state, rec[:, 3].to(torch.int32)))
    for name, x, y in pairs:
        if not torch.equal(x, y):
            fail(f"gotoh_forward {name} differs at {where}: "
                 f"{int((x != y).sum())} elements")
    return float((k.score - rec[:, 0]).abs().max()) if rec.shape[0] else 0.0


def check_sw(B, n, m, *, seed, broadcast=False, ragged=False):
    """Kernel vs plain version, global and local; raises on any differing
    byte or record field, returns the largest score difference."""
    import torch
    from repro_torch.core import alphabet as ab
    from repro_torch.kernels.sw import ops, ref
    a, b, lens = sw_inputs(B, n, m, seed=seed, broadcast=broadcast,
                           ragged=ragged)
    sub = torch.as_tensor(ab.dna_matrix(), dtype=torch.float32,
                          device="cuda")
    err = 0.0
    for local in (False, True):
        k = ops.gotoh_forward(a, b, lens, sub, gap_open=3, gap_extend=1,
                              local=local)
        p = ref.gotoh_forward_ref(a, b, lens, sub, gap_open=3, gap_extend=1,
                                  local=local)
        err = max(err, same_sw(k, p, f"B={B} n={n} m={m} local={local}"))
    print(f"gotoh_forward exact vs plain: B={B} n={n} m={m} "
          f"broadcast={broadcast} ragged={ragged} (global, local)")
    return err


def time_sw(B, n, m, broadcast, local):
    """Time the kernel and its plain version at a main-path shape and hold
    the two outputs bit-exact; returns (timings, largest score error)."""
    import torch
    from repro_torch.core import alphabet as ab
    from repro_torch.kernels.sw import ops, ref
    a, b, lens = sw_inputs(B, n, m, seed=7, broadcast=broadcast)
    sub = torch.as_tensor(ab.dna_matrix(), dtype=torch.float32,
                          device="cuda")
    kw = dict(gap_open=3, gap_extend=1, local=local)
    ms, k = cuda_ms(lambda: ops.gotoh_forward(a, b, lens, sub, **kw))
    plain_ms, p = cuda_ms(
        lambda: ref.gotoh_forward_ref(a, b, lens, sub, **kw), reps=1)
    err = same_sw(k, p, f"main-path shape B={B} n={n} m={m} "
                        f"broadcast={broadcast} local={local}")
    del k, p
    print(f"gotoh_forward exact vs plain: B={B} n={n} m={m} "
          f"broadcast={broadcast} local={local} (main-path shape)")
    cells = B * n * (m + 1)
    nbytes = cells + B * n + (m if broadcast else B * m) + B * 8 + B * 32
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cells * SW_OPS_PER_CELL / F32_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None), err


# ------------------------------------------------------------------ kernel 2

def mv_inputs(N, M, L, seed):
    import torch
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(0, 6, (N, L)).astype(np.int8))
    b = torch.from_numpy(rng.integers(0, 6, (M, L)).astype(np.int8))
    return a.cuda(), b.cuda()


def same_mv(k, plain, where: str) -> float:
    """Hold the kernel's (match, valid) exact against the plain version's;
    returns the largest count difference."""
    import torch
    (km, kv), (pm, pv) = k, plain
    if not (torch.equal(km, pm) and torch.equal(kv, pv)):
        fail(f"match_valid differs at {where}: "
             f"{int((km != pm).sum())} match, {int((kv != pv).sum())} valid")
    return float(max((km - pm).abs().max(), (kv - pv).abs().max()))


def check_mv(N, M, L, *, seed, same=False):
    from repro_torch.kernels.distance import ops, ref
    a, b = mv_inputs(N, M, L, seed)
    if same:
        b = a
    err = same_mv(ops.match_valid(a, b, n_chars=5, gap_code=5),
                  ref.match_valid_ref(a, b, n_chars=5, gap_code=5),
                  f"N={N} M={M} L={L}")
    print(f"match_valid exact vs plain: N={N} M={M} L={L}")
    return err


def time_mv(N, L):
    """Time the kernel, its plain version and one library call at the
    main-path shape and hold the kernel exact against the plain version;
    returns (timings, largest count error)."""
    import torch
    from repro_torch.kernels.distance import ops, ref
    a, _ = mv_inputs(N, N, L, seed=11)
    ms, k = cuda_ms(lambda: ops.match_valid(a, a, n_chars=5, gap_code=5))
    plain_ms, p = cuda_ms(lambda: ref.match_valid_ref(a, a, n_chars=5,
                                                      gap_code=5), reps=1)
    err = same_mv(k, p, f"main-path shape N={N} L={L}")
    del k, p
    print(f"match_valid exact vs plain: N=M={N} L={L} (main-path shape)")
    # yardstick: one float32 product of the prebuilt one-hot (the match
    # counts), never called by the port
    al = a.long()
    oh = ((al[:, :, None] == torch.arange(5, device="cuda"))
          & (al[:, :, None] != 5)).to(torch.float32).reshape(N, -1)
    library_ms, _ = cuda_ms(lambda: torch.matmul(oh, oh.T))
    del oh
    nbytes = 2 * N * L + 2 * 4 * N * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * N * N * L / INT8_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms), err


# ----------------------------------------------------------------- main path

def run_main_path(work: Path):
    """msa_run at its defaults on a Phi_RNA-shaped family; returns the
    launches per kernel, the shapes kernel 1 was given, and stage seconds."""
    import torch
    from repro_torch.data import SimConfig, read_fasta, simulate_family, \
        write_fasta
    from repro_torch.kernels.distance import ops as mv_ops
    from repro_torch.kernels.sw import ops as sw_ops
    from repro_torch.launch import msa_run
    from repro_torch.obs import trace

    t0 = time.time()
    fam = simulate_family(SimConfig(n_leaves=N_SEQS, root_len=1440,
                                    branch_sub=0.01, branch_indel=0.001,
                                    seed=1))
    fasta = work / "phi_rna_4096.fa"
    write_fasta(fasta, fam.names, fam.seqs)
    print(f"main path input: {N_SEQS} sequences, lengths "
          f"{min(map(len, fam.seqs))}..{max(map(len, fam.seqs))}, "
          f"simulated in {time.time() - t0:.1f} s")

    # observe (not alter) the shapes the main path gives kernel 1
    shapes = []
    forward = sw_ops.gotoh_forward

    def observe(a, b, lens, sub, **kw):
        shapes.append((a.shape[0], a.shape[1], b.shape[1],
                       b.shape[0] > 1 and b.stride(0) == 0, kw["local"]))
        return forward(a, b, lens, sub, **kw)
    sw_ops.gotoh_forward = observe

    out = work / "out"
    trace.TRACER.clear()
    torch.cuda.reset_peak_memory_stats()
    sw_ops.launches = 0
    mv_ops.launches = 0
    t0 = time.time()
    try:
        msa_run.main(["--fasta", str(fasta), "--out", str(out)])
        torch.cuda.synchronize()
    finally:
        sw_ops.gotoh_forward = forward
    wall = time.time() - t0
    launches = {"gotoh_forward": sw_ops.launches,
                "match_valid": mv_ops.launches}
    stages = {}
    for rec in trace.TRACER.spans():
        stages[rec.name] = stages.get(rec.name, 0.0) + rec.duration
    print("main path stage seconds: " + json.dumps(
        {k: round(stages.get(k, 0.0), 3) for k in
         ("load", "encode", "center", "map1", "assemble", "write", "score",
          "tree.distance", "tree.nj", "msa_run")}) + f" (wall {wall:.2f} s)")
    print(f"main path peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"main path kernel launches: {json.dumps(launches)}; "
          f"gotoh_forward shapes (B, n, m, broadcast, local): "
          f"{sorted(set(shapes))}")

    # --- outputs are right
    names, rows = read_fasta(out / "aligned.fasta")
    if names != fam.names:
        fail("aligned.fasta names differ from the input")
    width = len(rows[0])
    if any(len(r) != width for r in rows):
        fail("aligned.fasta rows have different widths")
    if any(r.replace("-", "") != s for r, s in zip(rows, fam.seqs)):
        fail("an ungapped aligned row differs from its input sequence")
    if width < max(map(len, fam.seqs)):
        fail(f"MSA width {width} below the longest input")
    nwk = (out / "tree.nwk").read_text().strip()
    leaves = re.findall(r"[(,]([^(),:;]+):", nwk)
    if (not nwk.endswith(";") or nwk.count("(") != nwk.count(")")
            or sorted(leaves) != sorted(fam.names)):
        fail(f"tree.nwk does not parse with {N_SEQS} leaves "
             f"({len(leaves)} found)")
    report = json.loads((out / "report.json").read_text())
    if not math.isfinite(report["avg_sp_penalty"]):
        fail(f"avg_sp_penalty {report['avg_sp_penalty']} is not finite")
    if not report["kmer_fallbacks"] > 0:
        fail("no k-mer fallback: the full-DP role of kernel 1 was not run")
    if report["backend"] != "cuda" or report["width"] != width:
        fail(f"report disagrees with the run: {report}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched on the main path")
    print(f"main path outputs ok: width {width}, "
          f"{report['kmer_fallbacks']} k-mer fallbacks, avg SP "
          f"{report['avg_sp_penalty']}")
    return launches, shapes, width


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    built = _build.build()
    print(f"built {sorted(built)} in {time.time() - t0:.1f} s")

    sw_err = max(check_sw(16384, 64, 64, seed=1),
                 check_sw(64, 2048, 1460, seed=2, broadcast=True),
                 check_sw(12, 37, 53, seed=3, ragged=True))
    mv_err = max(check_mv(4096, 4096, 1600, seed=4, same=True),
                 check_mv(257, 130, 33, seed=5))

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    launches, shapes, width = run_main_path(work)

    # kernel 1 in both main-path roles: the inter-anchor segment batch
    # (per-pair targets) and the full-DP fallback batch (broadcast
    # center); the JSON line carries the larger of the two
    timed = {}
    for role, calls in (("segment", [s for s in shapes if not s[3]]),
                        ("fallback", [s for s in shapes if s[3]])):
        for shape in sorted(set(calls)):
            t, err = time_sw(*shape)
            sw_err = max(sw_err, err)
            timed[shape] = t
            print(f"gotoh_forward at main-path {role} shape {shape}: "
                  f"{json.dumps(t)}")
    sw = timed[max(timed, key=lambda s: s[0] * s[1] * s[2])]
    mv, err = time_mv(N_SEQS, width)
    mv_err = max(mv_err, err)
    print(f"match_valid at main-path shape N={N_SEQS} L={width}: "
          f"{json.dumps(mv)}")

    kernels = [
        dict(name="gotoh_forward", route="cuda",
             source="src/repro_torch/csrc/sw_forward.cu",
             replaces="src/repro/kernels/sw/sw_kernel.py:140",
             launches=launches["gotoh_forward"], max_abs_err=sw_err, **sw),
        dict(name="match_valid", route="cuda",
             source="src/repro_torch/csrc/match_valid.cu",
             replaces="src/repro/kernels/distance/distance_kernel.py:63",
             launches=launches["match_valid"], max_abs_err=mv_err, **mv),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
