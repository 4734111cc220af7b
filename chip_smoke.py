#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. print the card's name and power limit (nvidia-smi);
  2. build the four CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
     each, started together) and print the build seconds;
  3. hold the Gotoh forward kernel bit-exact against its plain PyTorch
     version, global and local, at the segment shape (B=16384, 64x64),
     the fallback shape (B=64, 2048x1460, broadcast target) and a ragged
     batch with lengths 0 and 1;
  4. hold the match/valid kernel exact against its plain version at
     N=4096, L=1600 and at a ragged N=257, M=130, L=33;
  5. hold the banded forward kernel and the fused banded kernel bit-exact
     against their plain versions at ragged small shapes (lengths 0 and
     1, W = 8, 64, 128, a band covering every column, a broadcast
     target) and the fused kernel in both of its variants (direction band
     in shared memory, in a device workspace); the fused kernel's outputs
     must also equal the banded forward kernel + the banded traceback;
  6. run the main path, ``repro_torch.launch.msa_run`` with default flags
     (``--method kmer --tree nj``), on a 4,096-sequence family simulated
     with the paper's Phi_RNA (16S rRNA) parameters, check its outputs and
     that kernels 1 and 2 were launched during the run;
  7. run the banded main path, ``msa_run --backend banded-pallas``, on the
     same family: check its outputs, that kernels 1-3 were launched, and
     print its band-overflow fallbacks and how many aligned rows differ
     from phase 6's (a finding: banding is a heuristic);
  8. run the search path, ``repro_torch.launch.search_run``, with the last
     4 of 4,100 simulated leaves as queries against the first 4,096:
     ``--score global`` under ``--backend banded-pallas`` (kernel 4) and
     ``banded`` (kernel 3 + traceback), whose hits must be equal, then
     ``--score local`` (kernel 1 local);
  9. on the inputs of the largest call each of phases 6-8 gave each
     kernel (kernel 1: for each mode and target form, so the full-DP
     fallbacks of the banded paths and the local search chunks too), hold
     the kernel bit-exact against its plain version again and time it
     beside that plain version, one PyTorch library call where there is
     one, and its bound;
 10. run the tree backends at 4,096 on phase 6's ``aligned.fasta``:
     ``repro_torch.launch.tree_run --tree-ll`` with ``--backend dense``,
     ``cluster`` and ``tiled --row-block 128``, then ``msa_run --tree
     tiled --tree-ll`` once; check each tree (4,096 leaves, finite logL,
     kernel 2 launched), that the cluster and tiled trees are bitwise
     equal and the tiled run stayed within one (128, N) strip, and print
     each run's seconds by stage, device peak, logL and normalized RF
     against the simulated tree;
 11. run ``tree_run --backend auto`` (which must resolve to ``tiled``)
     and ``--backend cluster`` on 65,536 aligned Phi_RNA-shaped rows
     (no indels, so no MSA run): the two trees bitwise equal, the tiled
     run within one strip; print seconds by stage, device peaks, kernel-2
     launches and normalized RF;
 12. for each tree run, hold kernel 2's largest call, one single-column
     call (M = 1) and one per-cluster square exact against the plain
     version and time them; then print each kernel on its own path as one
     JSON line.

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
N_BIG = 65536          # the tree backends' large run
# H100 SXM peak rates: HBM, f32 outside the tensor
# cores, int8 tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
# f32 operations per DP cell of the Gotoh forward: 3 max + 2 compare for
# h and its argmax, add + compare + 2 select (local) for M, 2 sub + max +
# compare for Ix, add + max (scan) + 2 sub for Iy, 2 sub + compare for dirIy
SW_OPS_PER_CELL = 20
# per band cell the banded forward adds the band masks (4 compares,
# 3 selects) and the edge-pressure compare to the Gotoh cell's work,
# less the local select
BANDED_OPS_PER_CELL = 25
N_QUERIES = 4


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


def time_sw(inputs):
    """Time the kernel and its plain version on the inputs a path gave it
    and hold the two outputs bit-exact; returns (timings, largest score
    error)."""
    from repro_torch.kernels.sw import ops, ref
    a, b, lens, sub, kw = inputs
    B, n = a.shape
    m = b.shape[1]
    broadcast = B > 1 and b.stride(0) == 0
    where = (f"path inputs B={B} n={n} m={m} broadcast={broadcast} "
             f"local={kw['local']}")
    ms, k = cuda_ms(lambda: ops.gotoh_forward(a, b, lens, sub, **kw))
    plain_ms, p = cuda_ms(
        lambda: ref.gotoh_forward_ref(a, b, lens, sub, **kw), reps=1)
    err = same_sw(k, p, where)
    del k, p
    print(f"gotoh_forward exact vs plain at the {where}")
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


def time_mv_inputs(a, b, where: str, *, n_chars=5, gap_code=5):
    """Time the kernel, its plain version and one library call on the
    inputs and hold the kernel exact against the plain version; returns
    (timings, largest count error)."""
    import torch
    from repro_torch.kernels.distance import ops, ref
    kw = dict(n_chars=n_chars, gap_code=gap_code)
    ms, k = cuda_ms(lambda: ops.match_valid(a, b, **kw))
    plain_ms, p = cuda_ms(lambda: ref.match_valid_ref(a, b, **kw), reps=1)
    err = same_mv(k, p, where)
    del k, p
    print(f"match_valid exact vs plain at {where}")
    # yardstick: one float32 product of the prebuilt one-hots (the match
    # counts), never called by the port
    sym = torch.arange(n_chars, device=a.device)

    def onehot(x):
        xl = x.long()
        return ((xl[:, :, None] == sym) & (xl[:, :, None] != gap_code)).to(
            torch.float32).reshape(x.shape[0], -1)
    oa, ob = onehot(a), onehot(b)
    library_ms, _ = cuda_ms(lambda: torch.matmul(oa, ob.T))
    del oa, ob
    N, L = a.shape
    M = b.shape[0]
    nbytes = (N + M) * L + 2 * 4 * N * M
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * N * M * L / INT8_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms), err


def time_mv(N, L):
    """Kernel 2 at the main-path shape (N x N, width L)."""
    a, _ = mv_inputs(N, N, L, seed=11)
    return time_mv_inputs(a, a, f"main-path shape N=M={N} L={L}")


# ------------------------------------------------------------- kernels 3, 4

def banded_inputs(B, n, m, *, seed, broadcast=False, ragged=False):
    """Pairs for the banded kernels: targets are mutated, shifted copies
    of the queries (band-sized offsets, so some pairs stay in the band
    and some press its edge)."""
    import torch
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (B, n)).astype(np.int8)
    b = np.full((1 if broadcast else B, m), 5, np.int8)
    width = min(n, m)
    b[:, :width] = a[: b.shape[0], :width]
    noise = rng.random(b.shape) < 0.1
    b[noise] = rng.integers(0, 4, int(noise.sum()))
    b[:, width:] = rng.integers(0, 4, (b.shape[0], m - width))
    shift = rng.integers(0, 9, b.shape[0])
    b = np.stack([np.roll(r, s) for r, s in zip(b, shift)])
    la = rng.integers(max(n // 2, 0), n + 1, B)
    lb = rng.integers(max(m // 2, 0), m + 1, B)
    if ragged:
        la[: B // 2] = rng.integers(0, 2, B // 2)
        lb[B // 4: 3 * B // 4] = rng.integers(0, 2, B // 2)
    dev = torch.device("cuda")
    bt = torch.from_numpy(b).to(dev)
    if broadcast:
        bt = bt.expand(B, m)
    return (torch.from_numpy(a).to(dev), bt,
            torch.from_numpy(np.stack([la, lb], 1).astype(np.int32)).to(dev))


def same_banded(k, plain, where: str) -> float:
    """Hold the kernel's ``BandedForward`` against the plain version's;
    raises on any differing byte or field, returns the largest score
    difference."""
    import torch
    for name in k._fields:
        x, y = getattr(k, name), getattr(plain, name)
        if not torch.equal(x, y):
            fail(f"banded_forward {name} differs at {where}: "
                 f"{int((x != y).sum())} elements")
    return float((k.score - plain.score).abs().max()) if len(k.score) else 0.0


def same_fused(k, plain, where: str, what="banded_fused") -> float:
    """Hold (score, a_row, b_row, aln_len, ok) tuples equal; returns the
    largest score difference."""
    import torch
    for name, x, y in zip(("score", "a_row", "b_row", "aln_len", "ok"),
                          k, plain):
        if not torch.equal(x, y):
            fail(f"{what} {name} differs at {where}: "
                 f"{int((x != y).sum())} elements")
    return float((k[0] - plain[0]).abs().max()) if len(k[0]) else 0.0


def fused_plain(a, b, lens, sub, *, gap_open, gap_extend, band, gap_code=5):
    """The fused kernel's plain version on the card: the plain forward and
    the plain traceback."""
    from repro_torch.kernels.banded import ref
    fwd = ref.banded_forward(a, lens[:, 0], b, lens[:, 1], sub,
                                  gap_open, gap_extend, band=band)
    a_row, b_row, k, ok = ref.banded_traceback(a, b, fwd, gap_code,
                                                    band=band)
    return fwd.score, a_row, b_row, k, ok


def check_banded_inputs(a, b, lens, sub, W, where: str):
    """Kernels 3 and 4 against their plain versions, and kernel 4 against
    kernel 3 + the banded traceback, on one input; returns the largest
    score difference."""
    from repro_torch.kernels.banded import ops, ref
    kw = dict(gap_open=3, gap_extend=1, band=W)
    k3 = ops.banded_forward(a, b, lens, sub, **kw)
    err = same_banded(k3, ref.banded_forward(
        a, lens[:, 0], b, lens[:, 1], sub, 3, 1, band=W), where)
    k4 = ops.banded_pairs_fused(a, b, lens, sub, **kw)
    err = max(err, same_fused(k4, fused_plain(a, b, lens, sub, **kw), where))
    a_row, b_row, k, ok = ref.banded_traceback(a, b, k3, 5, band=W)
    same_fused(k4, (k3.score, a_row, b_row, k, ok), where,
               "banded_fused vs banded_forward + traceback:")
    return err


def check_banded(B, n, m, W, *, seed, broadcast=False, ragged=False):
    import torch
    from repro_torch.core import alphabet as ab
    from repro_torch.kernels.banded import ops
    a, b, lens = banded_inputs(B, n, m, seed=seed, broadcast=broadcast,
                               ragged=ragged)
    sub = torch.as_tensor(ab.dna_matrix(), dtype=torch.float32,
                          device="cuda")
    where = f"B={B} n={n} m={m} W={W} broadcast={broadcast} ragged={ragged}"
    err = check_banded_inputs(a, b, lens, sub, W, where)
    print(f"banded_forward and banded_fused ({ops.fused_variant(n, W)}) "
          f"exact vs plain, fused == forward + traceback: {where}")
    return err


def banded_bound(B, n, m, W, broadcast, fused):
    """Least time for the banded kernels' work on the H100: the inputs
    read once and the outputs written once (kernel 3: the direction band;
    kernel 4: two aligned rows) against BANDED_OPS_PER_CELL f32 operations
    per band cell."""
    inputs = B * n + (m if broadcast else B * m) + B * 8
    outputs = B * 32 + (2 * B * (n + m) if fused else B * n * W)
    t_bytes = (inputs + outputs) / HBM_BYTES_PER_S * 1e3
    t_ops = B * n * W * BANDED_OPS_PER_CELL / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_banded(inputs, *, fused):
    """Time kernel 3 or 4 and its plain version on the inputs a path gave
    it and hold the two outputs bit-exact; returns (timings, error)."""
    from repro_torch.kernels.banded import ops, ref
    a, b, lens, sub, kw = inputs
    B, n = a.shape
    m = b.shape[1]
    broadcast = B > 1 and b.stride(0) == 0
    where = (f"path inputs B={B} n={n} m={m} W={kw['band']} "
             f"broadcast={broadcast}")
    if fused:
        ms, k = cuda_ms(lambda: ops.banded_pairs_fused(a, b, lens, sub, **kw))
        plain_ms, p = cuda_ms(lambda: fused_plain(a, b, lens, sub, **kw),
                              reps=1)
        err = same_fused(k, p, where)
    else:
        ms, k = cuda_ms(lambda: ops.banded_forward(a, b, lens, sub, **kw))
        plain_ms, p = cuda_ms(lambda: ref.banded_forward(
            a, lens[:, 0], b, lens[:, 1], sub, kw["gap_open"],
            kw["gap_extend"], band=kw["band"]), reps=1)
        err = same_banded(k, p, where)
    del k, p
    name = "banded_fused" if fused else "banded_forward"
    print(f"{name} exact vs plain at the {where}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                **banded_bound(B, n, m, kw["band"], broadcast, fused)), err


# ----------------------------------------------------------------- main path

def stage_seconds(names):
    from repro_torch.obs import trace
    stages = {}
    for rec in trace.TRACER.spans():
        stages[rec.name] = stages.get(rec.name, 0.0) + rec.duration
    return {k: round(stages.get(k, 0.0), 3) for k in names}


def fallback_pairs() -> float:
    """Pairs the align engine re-aligned after a band overflow, so far."""
    from repro_torch.obs import metrics
    fam = metrics.REGISTRY.snapshot().get("repro_align_fallback_pairs_total")
    return sum(s["value"] for s in fam["samples"]) if fam else 0.0


class Observe:
    """Reset the kernel launch counts, then watch a path's calls (not
    altering them): kernel 1's shapes, the inputs of each kernel's largest
    call (kernel 1's for each mode and target form), the band-overflow
    fallbacks, and the peak device memory of the path's stages
    (each stage's own peak; the run's peak is the largest of them and of
    the memory peaks between stages). With ``tree=True`` also kernel 2's
    largest call in each role and the tree engine's result."""

    def __init__(self, tree: bool = False):
        from repro_torch.align.engine import AlignEngine
        from repro_torch.core import msa
        from repro_torch.kernels.banded import ops as bd_ops
        from repro_torch.kernels.distance import ops as mv_ops
        from repro_torch.kernels.sw import ops as sw_ops
        from repro_torch.phylo.engine import TreeEngine
        from repro_torch.search.engine import SearchEngine
        self.mods = (sw_ops, mv_ops, bd_ops)
        self.sw_shapes = []
        self.largest = {}
        self.mv_largest = {}
        self.tree_result = None
        self.stage_peaks = {}
        self.running = 0
        self.targets = [
            (sw_ops, "gotoh_forward", self._keep("gotoh_forward")),
            (bd_ops, "banded_forward", self._keep("banded_forward")),
            (bd_ops, "banded_pairs_fused", self._keep("banded_fused")),
            (msa, "map1_align_to_center", self._stage("map1")),
            (msa, "assemble_center_star", self._stage("assemble")),
            (SearchEngine, "seed_counts", self._stage("search.seed")),
            (AlignEngine, "align_pairs", self._stage("search.rescore"))]
        if tree:
            self.targets += [(mv_ops, "match_valid", self._keep_mv),
                             (TreeEngine, "build", self._keep_tree)]

    def _keep(self, name):
        """Wrap a kernel wrapper: keep a copy of the inputs of its largest
        call for each role (mode and target form)."""
        def wrap(fn):
            def wrapped(a, b, lens, sub, **kw):
                broadcast = b.shape[0] > 1 and b.stride(0) == 0
                role = "broadcast target" if broadcast else "per-pair targets"
                if name == "gotoh_forward":
                    self.sw_shapes.append((a.shape[0], a.shape[1], b.shape[1],
                                           broadcast, kw["local"]))
                    role = ("local, " if kw["local"] else "global, ") + role
                size = a.shape[0] * a.shape[1] * max(b.shape[1], 1)
                if size > self.largest.get((name, role), (0,))[0]:
                    own = (b[:1].clone().expand(b.shape) if broadcast
                           else b.clone())
                    self.largest[(name, role)] = (
                        size, (a.clone(), own, lens.clone(), sub.clone(),
                               dict(kw)))
                return fn(a, b, lens, sub, **kw)
            return wrapped
        return wrap

    def _keep_mv(self, fn):
        """Wrap kernel 2's wrapper: keep a host copy of the inputs of its
        largest call in each role (single-column calls, else the span it
        ran in), off the card so that later runs' peaks do not see it."""
        from repro_torch.obs import trace

        def wrapped(a, b, **kw):
            role = ("M=1" if b.shape[0] == 1
                    else trace.current_span_name() or "-")
            size = a.shape[0] * b.shape[0] * a.shape[1]
            if size > self.mv_largest.get(role, (0,))[0]:
                self.mv_largest[role] = (size, (a.cpu(), b.cpu(),
                                                dict(kw)))
            return fn(a, b, **kw)
        return wrapped

    def _keep_tree(self, fn):
        """Wrap the tree engine's ``build``: keep its result and its own
        peak device memory (stage ``tree``)."""
        build = self._stage("tree")(fn)

        def wrapped(engine, *args, **kw):
            self.tree_result = build(engine, *args, **kw)
            return self.tree_result
        return wrapped

    def _stage(self, name):
        import torch

        def wrap(fn):
            def wrapped(*args, **kw):
                torch.cuda.synchronize()
                self.running = max(self.running,
                                   torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                try:
                    return fn(*args, **kw)
                finally:
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated()
                    self.stage_peaks[name] = max(
                        self.stage_peaks.get(name, 0), peak)
                    self.running = max(self.running, peak)
            return wrapped
        return wrap

    def __enter__(self):
        import torch
        sw_ops, mv_ops, bd_ops = self.mods
        self.saved = [(obj, attr, getattr(obj, attr))
                      for obj, attr, _ in self.targets]
        for (obj, attr, wrap), (_, _, fn) in zip(self.targets, self.saved):
            setattr(obj, attr, wrap(fn))
        sw_ops.launches = mv_ops.launches = 0
        bd_ops.forward_launches = bd_ops.fused_launches = 0
        for variant in bd_ops.fused_variant_launches:
            bd_ops.fused_variant_launches[variant] = 0
        self.fallbacks0 = fallback_pairs()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        sw_ops, mv_ops, bd_ops = self.mods
        self.launches = {"gotoh_forward": sw_ops.launches,
                         "match_valid": mv_ops.launches,
                         "banded_forward": bd_ops.forward_launches,
                         "banded_fused": bd_ops.fused_launches}
        self.fused_variants = dict(bd_ops.fused_variant_launches)
        for obj, attr, fn in self.saved:
            setattr(obj, attr, fn)
        self.fallbacks = int(fallback_pairs() - self.fallbacks0)
        self.peak_gib = max(self.running,
                            torch.cuda.max_memory_allocated()) / 2**30
        return False

    def peaks(self) -> str:
        """The run's and its stages' peak device memory, in GiB."""
        stages = ", ".join(f"{k} {v / 2**30:.3f}"
                           for k, v in sorted(self.stage_peaks.items()))
        return f"{self.peak_gib:.3f} GiB (stage peaks: {stages})"

    def calls(self):
        """((kernel, role), size, inputs) of each kept largest call."""
        return [(key, size, inputs) for key, (size, inputs)
                in sorted(self.largest.items())]


def check_msa(out: Path, fam, backend: str):
    """The run's aligned FASTA, tree and report are right; returns (rows,
    report)."""
    from repro_torch.data import read_fasta
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
        fail(f"tree.nwk does not parse with {len(fam.names)} leaves "
             f"({len(leaves)} found)")
    report = json.loads((out / "report.json").read_text())
    if not math.isfinite(report["avg_sp_penalty"]):
        fail(f"avg_sp_penalty {report['avg_sp_penalty']} is not finite")
    if not report["kmer_fallbacks"] > 0:
        fail("no k-mer fallback: the full-DP role of kernel 1 was not run")
    if report["backend"] != backend or report["width"] != width:
        fail(f"report disagrees with the run: {report}")
    return rows, report


MSA_STAGES = ("load", "encode", "center", "map1", "assemble", "write",
              "score", "tree.distance", "tree.nj", "msa_run")


def run_msa(fam, fasta: Path, out: Path, label: str, flags, backend: str,
            kernels, stages=MSA_STAGES):
    """One ``msa_run`` with the launch counts reset just before it; checks
    its outputs and that each of ``kernels`` was launched."""
    from repro_torch.launch import msa_run
    from repro_torch.obs import trace
    trace.TRACER.clear()
    t0 = time.time()
    with Observe() as obs:
        msa_run.main(["--fasta", str(fasta), "--out", str(out), *flags])
    wall = time.time() - t0
    print(f"{label} stage seconds: {json.dumps(stage_seconds(stages))} "
          f"(wall {wall:.2f} s)")
    print(f"{label} peak device memory: {obs.peaks()}")
    print(f"{label} kernel launches: {json.dumps(obs.launches)}; "
          f"gotoh_forward shapes (B, n, m, broadcast, local): "
          f"{sorted(set(obs.sw_shapes))}")
    rows, report = check_msa(out, fam, backend)
    for name in kernels:
        if obs.launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {label}")
    print(f"{label} outputs ok: width {report['width']}, "
          f"{report['kmer_fallbacks']} k-mer fallbacks, "
          f"{obs.fallbacks} band-overflow fallbacks, avg SP "
          f"{report['avg_sp_penalty']}")
    return obs, rows, report


def simulate(n_leaves: int, indel: float = 0.001):
    from repro_torch.data import SimConfig, simulate_family
    t0 = time.time()
    fam = simulate_family(SimConfig(n_leaves=n_leaves, root_len=1440,
                                    branch_sub=0.01, branch_indel=indel,
                                    seed=1))
    print(f"simulated {n_leaves} Phi_RNA-shaped sequences, lengths "
          f"{min(map(len, fam.seqs))}..{max(map(len, fam.seqs))}, in "
          f"{time.time() - t0:.1f} s")
    return fam


# -------------------------------------------------------------- search path

SEARCH_STAGES = ("index", "search.seed", "search.rescore", "search",
                 "search_run")


def run_search(work: Path, db, queries, label: str, flags, kernels):
    """One ``search_run`` with the launch counts reset just before it;
    checks its outputs and that each of ``kernels`` was launched."""
    from repro_torch.launch import search_run
    from repro_torch.obs import trace
    out = work / label.replace(" ", "_")
    trace.TRACER.clear()
    t0 = time.time()
    with Observe() as obs:
        search_run.main(["--db", str(db), "--query", str(queries),
                         "--index", str(work / "db.idx.npz"),
                         "--out", str(out), *flags])
    wall = time.time() - t0
    hits = json.loads((out / "hits.json").read_text())
    st = hits["stats"]
    print(f"search {label}: stage seconds "
          f"{json.dumps(stage_seconds(SEARCH_STAGES))} (wall {wall:.2f} s), "
          f"peak device memory {obs.peaks()}, survival "
          f"{st['survival']}, candidates {st['candidates']}, band "
          f"fallbacks {obs.fallbacks}, align calls "
          f"{st['align_calls']}, kernel launches {json.dumps(obs.launches)} "
          f"(fused variants {json.dumps(obs.fused_variants)})")
    for q in hits["queries"]:
        if not q["hits"]:
            fail(f"search {label}: query {q['name']} found no hit")
        scores = [h["score"] for h in q["hits"]]
        if scores != sorted(scores, reverse=True) or not all(
                math.isfinite(h["evalue"]) for h in q["hits"]):
            fail(f"search {label}: hits of {q['name']} are not ranked")
    for name in kernels:
        if obs.launches[name] <= 0:
            fail(f"kernel {name} was not launched on search {label}")
    print(f"search {label}: top hits "
          f"{[(q['name'], q['hits'][0]['target'], q['hits'][0]['score']) for q in hits['queries']]}")
    return obs, hits["queries"]


def hold_path_calls(runs):
    """Each kernel on the inputs of the largest call each run gave it (for
    kernel 1, each mode and target form): held bit-exact against its plain
    version again, and timed. Returns (largest error per kernel, timings
    per (run, kernel) as (call size, timings) pairs)."""
    err = dict.fromkeys(("gotoh_forward", "banded_forward", "banded_fused"),
                        0.0)
    timed = {}
    for label, obs in runs:
        for (name, role), size, inputs in obs.calls():
            t, e = (time_sw(inputs) if name == "gotoh_forward" else
                    time_banded(inputs, fused=name == "banded_fused"))
            err[name] = max(err[name], e)
            timed.setdefault((label, name), []).append((size, t))
            print(f"{name} ({role}) on the {label}'s largest call "
                  f"{tuple(inputs[0].shape)} x {inputs[1].shape[1]}: "
                  f"{json.dumps(t)}")
        del obs.largest
    return err, timed


# --------------------------------------------------------------- tree paths

TREE_STAGES = ("load", "tree.distance", "tree.nj", "tree.medoids",
               "tree.assign", "tree.cluster_nj", "tree.stitch", "tree",
               "loglik", "write", "tree_run")


def split_hashes(children, root, n, keys):
    """The non-trivial splits of a tree as 64-bit hashes: a clade hashes
    to the XOR of its leaves' random keys, a split to the smaller of its
    two sides' hashes. Node ids must be topological (children below their
    parent), as NJ, the stitch and the simulator number them."""
    children = np.asarray(children)
    h = np.zeros(children.shape[0], np.uint64)
    size = np.zeros(children.shape[0], np.int64)
    h[:n], size[:n] = keys, 1
    total = np.bitwise_xor.reduce(keys)
    for node in range(n, children.shape[0]):
        c0, c1 = children[node]
        if c0 >= 0:
            h[node] = h[c0] ^ h[c1]
            size[node] = size[c0] + size[c1]
    inner = [v for v in range(n, children.shape[0])
             if v != root and 1 < size[v] < n - 1]
    return {min(int(h[v]), int(total ^ h[v])) for v in inner}


def normalized_rf(tree, true_tree, n) -> float:
    """Robinson-Foulds distance between two trees over leaves 0..n-1,
    over its most, 2 (n - 3)."""
    keys = np.random.default_rng(0).integers(1, 2**63, n, dtype=np.uint64)
    a = split_hashes(tree[0], tree[1], n, keys)
    b = split_hashes(true_tree[0], true_tree[1], n, keys)
    return len(a ^ b) / (2 * max(n - 3, 1))


def run_tree(fasta: Path, out: Path, label: str, flags, n: int, true_tree):
    """One ``tree_run`` with the launch counts reset just before it; checks
    its tree and report and that kernel 2 was launched; returns (observer,
    report)."""
    from repro_torch.launch import tree_run
    from repro_torch.obs import trace
    trace.TRACER.clear()
    t0 = time.time()
    with Observe(tree=True) as obs:
        tree_run.main(["--fasta", str(fasta), "--out", str(out), *flags])
    wall = time.time() - t0
    report = json.loads((out / "report.json").read_text())
    res = obs.tree_result
    nwk = (out / "tree.nwk").read_text().strip()
    if (report["n_sequences"] != n or res.n_leaves != n
            or nwk.count(",") != n - 1 or not nwk.endswith(";")):
        fail(f"tree {label}: the tree does not have {n} leaves")
    ll = report.get("log_likelihood")
    if "--tree-ll" in flags and not (ll is not None and math.isfinite(ll)):
        fail(f"tree {label}: log-likelihood {ll} is not finite")
    if obs.launches["match_valid"] <= 0:
        fail(f"kernel match_valid was not launched on the tree {label}")
    nrf = normalized_rf((res.children, res.root), true_tree, n)
    print(f"tree {label}: backend {report['backend']}, stage seconds "
          f"{json.dumps(stage_seconds(TREE_STAGES))} (wall {wall:.2f} s), "
          f"peak device memory {obs.peaks()}, match_valid "
          f"launches {obs.launches['match_valid']}, logL {ll}, normalized "
          f"RF vs the simulated tree {nrf:.4f}, tile_stats "
          f"{json.dumps(report['tile_stats'])}")
    return obs, report


def same_tree(a, b, what: str) -> None:
    """Two tree runs gave bitwise-equal trees and equal Newick files."""
    (obs_a, out_a), (obs_b, out_b) = a, b
    ra, rb = obs_a.tree_result, obs_b.tree_result
    if not (np.array_equal(ra.children, rb.children)
            and np.array_equal(ra.blen, rb.blen) and ra.root == rb.root):
        fail(f"{what}: the trees differ")
    if (out_a / "tree.nwk").read_bytes() != (out_b / "tree.nwk").read_bytes():
        fail(f"{what}: the Newick files differ")
    print(f"{what}: children, branch lengths and Newick bitwise equal")


def within_strip(report, n: int, label: str) -> None:
    peak = report["tile_stats"]["peak_resident_bytes"]
    if report["backend"] != "tiled" or not 0 < peak <= 128 * n * 4:
        fail(f"tree {label}: backend {report['backend']}, resident peak "
             f"{peak} bytes against one strip of {128 * n * 4}")


def hold_tree_calls(runs) -> float:
    """Kernel 2 on each tree run's largest call, one single-column call
    and one per-cluster square: held exact against its plain version and
    timed. Returns the largest count error."""
    err = 0.0
    for label, obs in runs:
        calls = obs.mv_largest
        top = max(calls, key=lambda r: calls[r][0])
        picks = [(f"largest call ({top})", calls[top])]
        picks += [(what, calls[role]) for what, role in
                  (("single column", "M=1"),
                   ("per-cluster square", "tree.cluster_nj"))
                  if role in calls and role != top]
        for what, (_, (a, b, kw)) in picks:
            a, b = a.cuda(), b.cuda()
            t, e = time_mv_inputs(a, b, f"the tree {label}'s {what} "
                                  f"{tuple(a.shape)} x {tuple(b.shape)}",
                                  **kw)
            err = max(err, e)
            print(f"match_valid {what} on the tree {label}: "
                  f"{tuple(a.shape)} x {tuple(b.shape)}: {json.dumps(t)}")
        obs.mv_largest = {}
    return err


def tree_phases(fam, fasta: Path, work: Path, n_big: int = N_BIG,
                route: str = "cuda") -> float:
    """Phases 10-12: the tree backends on ``fam``'s alignment from phase 6
    and on ``n_big`` simulated aligned rows, then kernel 2's tree calls
    held against its plain version. Returns the largest count error."""
    from repro_torch.data import write_fasta
    n = len(fam.names)
    # the tree backends at 4,096, on phase 6's alignment
    aligned = work / "out" / "aligned.fasta"
    truth = (fam.children, fam.root)
    tree_runs = {}
    for label, flags in (("dense", ["--backend", "dense"]),
                         ("cluster", ["--backend", "cluster"]),
                         ("tiled", ["--backend", "tiled",
                                    "--row-block", "128"])):
        out = work / f"tree_{label}"
        tree_runs[f"{label} {n}"] = (run_tree(
            aligned, out, f"{label} {n}", [*flags, "--tree-ll"],
            n, truth)[0], out)
    within_strip(json.loads((work / "tree_tiled" / "report.json")
                            .read_text()), n, f"tiled {n}")
    same_tree(tree_runs[f"cluster {n}"], tree_runs[f"tiled {n}"],
              f"cluster and tiled at {n}")
    _, _, treport = run_msa(
        fam, fasta, work / "out_tree", "main path --tree tiled --tree-ll",
        ["--tree", "tiled", "--tree-ll"], route,
        ("gotoh_forward", "match_valid"),
        stages=MSA_STAGES + TREE_STAGES[3:7] + ("loglik",))
    if treport["tree_backend"] != "tiled" or not math.isfinite(
            treport["log_likelihood"]):
        fail(f"msa_run --tree tiled --tree-ll: {treport}")
    print(f"msa_run --tree tiled --tree-ll: logL "
          f"{treport['log_likelihood']}, tile_stats "
          f"{json.dumps(treport['tile_stats'])}")

    # the tree backends at n_big aligned rows (no indels: no MSA run)
    big = simulate(n_big, indel=0.0)
    big_fa = work / f"phi_rna_{n_big}_aligned.fa"
    write_fasta(big_fa, big.names, big.seqs)
    big_truth = (big.children, big.root)
    del big
    for label, flags in (("auto", ["--backend", "auto"]),
                         ("cluster", ["--backend", "cluster"])):
        out = work / f"tree_{label}_{n_big}"
        obs, report = run_tree(big_fa, out, f"{label} {n_big}", flags,
                               n_big, big_truth)
        tree_runs[f"{label} {n_big}"] = (obs, out)
        if label == "auto":
            within_strip(report, n_big, f"auto {n_big}")
    same_tree(tree_runs[f"auto {n_big}"], tree_runs[f"cluster {n_big}"],
              f"auto (tiled) and cluster at {n_big}")
    return hold_tree_calls((label, obs)
                           for label, (obs, _) in tree_runs.items())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.data import write_fasta

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
    bd_err = max(check_banded(12, 37, 53, 8, seed=6, ragged=True),
                 check_banded(12, 53, 37, 64, seed=7, ragged=True),
                 check_banded(16, 90, 120, 128, seed=8),
                 check_banded(8, 40, 31, 64, seed=9),       # W >= 2*lb + 2
                 check_banded(16, 200, 180, 64, seed=10, broadcast=True),
                 check_banded(16, 1700, 1800, 128, seed=11))  # global variant

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    fam = simulate(N_SEQS)
    fasta = work / "phi_rna_4096.fa"
    write_fasta(fasta, fam.names, fam.seqs)

    main_obs, rows, report = run_msa(
        fam, fasta, work / "out", "main path", [], "cuda",
        ("gotoh_forward", "match_valid"))
    width = report["width"]
    bd_obs, brows, _ = run_msa(
        fam, fasta, work / "out_banded", "banded main path",
        ["--backend", "banded-pallas"], "cuda-banded",
        ("gotoh_forward", "match_valid", "banded_forward"))
    print(f"banded main path: {sum(x != y for x, y in zip(rows, brows))} of "
          f"{len(rows)} aligned rows differ from the main path's (widths "
          f"{len(brows[0])} and {len(rows[0])})")

    # search: the last N_QUERIES of N_SEQS + N_QUERIES leaves against the
    # first N_SEQS
    sfam = simulate(N_SEQS + N_QUERIES)
    write_fasta(work / "db.fa", sfam.names[:N_SEQS], sfam.seqs[:N_SEQS])
    write_fasta(work / "q.fa", sfam.names[N_SEQS:], sfam.seqs[N_SEQS:])
    (work / "db.idx.npz").unlink(missing_ok=True)
    glob = ["--score", "global", "--max-hits", "10"]
    fused_obs, fused_hits = run_search(
        work, work / "db.fa", work / "q.fa", "global banded-pallas",
        glob + ["--backend", "banded-pallas"], ("banded_fused",))
    banded_obs, banded_hits = run_search(
        work, work / "db.fa", work / "q.fa", "global banded",
        glob + ["--backend", "banded"], ("banded_forward",))
    if fused_hits != banded_hits:
        fail("search hits differ between --backend banded-pallas (kernel 4) "
             "and banded (kernel 3 + traceback)")
    print("search hits equal under banded-pallas and banded")
    local_obs, _ = run_search(work, work / "db.fa", work / "q.fa", "local",
                              ["--score", "local", "--max-hits", "10"],
                              ("gotoh_forward",))

    err, timed = hold_path_calls(
        (("main path", main_obs), ("banded main path", bd_obs),
         ("search global banded-pallas", fused_obs),
         ("search global banded", banded_obs), ("search local", local_obs)))
    err["gotoh_forward"] = max(err["gotoh_forward"], sw_err)
    for name in ("banded_forward", "banded_fused"):
        err[name] = max(err[name], bd_err)
    # the kernels line: each kernel on its own path's largest call
    sw = max(timed[("main path", "gotoh_forward")], key=lambda x: x[0])[1]
    bf = max(timed[("banded main path", "banded_forward")],
             key=lambda x: x[0])[1]
    fu = max(timed[("search global banded-pallas", "banded_fused")],
             key=lambda x: x[0])[1]
    mv, e = time_mv(N_SEQS, width)
    mv_err = max(mv_err, e)
    print(f"match_valid at main-path shape N={N_SEQS} L={width}: "
          f"{json.dumps(mv)}")

    mv_err = max(mv_err, tree_phases(fam, fasta, work))

    kernels = [
        dict(name="gotoh_forward", route="cuda",
             source="src/repro_torch/csrc/sw_forward.cu",
             replaces="src/repro/kernels/sw/sw_kernel.py:140",
             launches=main_obs.launches["gotoh_forward"],
             max_abs_err=err["gotoh_forward"],
             **sw),
        dict(name="match_valid", route="cuda",
             source="src/repro_torch/csrc/match_valid.cu",
             replaces="src/repro/kernels/distance/distance_kernel.py:63",
             launches=main_obs.launches["match_valid"], max_abs_err=mv_err,
             **mv),
        dict(name="banded_forward", route="cuda",
             source="src/repro_torch/csrc/banded_forward.cu",
             replaces="src/repro/kernels/banded/banded_kernel.py:117",
             launches=bd_obs.launches["banded_forward"],
             max_abs_err=err["banded_forward"],
             **bf),
        dict(name="banded_fused", route="cuda",
             source="src/repro_torch/csrc/banded_fused.cu",
             replaces="src/repro/kernels/banded/banded_kernel.py:245",
             launches=fused_obs.launches["banded_fused"],
             max_abs_err=err["banded_fused"],
             **fu),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
