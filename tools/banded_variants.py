#!/usr/bin/env python3
"""Time the banded kernels (kernels 3 and 4) beside design variants and
with parts of their work cut out.

    python3 tools/banded_variants.py      # one NVIDIA H100 and nvcc
    python3 tools/banded_variants.py --parent build/parent

Builds copies of ``src/repro_torch/csrc/banded_fused.cu`` and
``banded_forward.cu`` (each beside its own copy of ``banded_row.cuh``)
into ``build/repro_torch/variants/`` (the sources in the tree are not
touched), each with fragments of code replaced (a fragment, never a
comment, that must occur once in its file) and prints each copy's
``nvcc -Xptxas -v`` registers and spills. ``VARIANTS`` change a design
choice and must stay exact (``bounds3``: 3 CTAs of 256 threads an SM in
``__launch_bounds__``, 85 registers, at K <= 2); the others drop one part
of the work, so they are not exact, and the time each saves is that
part's share: ``fwd_only`` (no traceback: the walk's share is the
kernel's time less this one's), ``no_dir_stores`` (the direction values
neither packed nor stored, so the compiler also drops their arithmetic),
``no_edge`` (no edge pressure), ``no_scan`` (no warp scan for Iy). Each
copy runs through its own C entries (kernel 4's grid from the copy's own
occupancy) at ``SHAPES`` in turns (the kernel, every copy, every copy
again in reverse, the kernel; CUDA events, 3 runs each after a warm-up)
and prints one JSON line per copy: its times, whether it equals the
plain version, and for the kernels the device bytes one call allocates
above what was in use (the fused kernel's workspace shows there).
``--parent DIR`` adds the two banded kernels of another checkout to the
turns, through the same C entries (kernel 4's sized workspace, its grid
from that copy's own occupancy). The copies here cover the warp route
(W <= 1,024); ``chip_smoke.py`` times the wide route.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FUSED_WALK = "while (!done && k < out_len) {"
NIBBLE_STORE = "store_bytes<K / 2>(row, w);"
BYTE_STORE = "store_bytes<K>(row, w);"
EDGE = "if (r <= la) {"
SCAN = "for (int off = 1; off < 32; off <<= 1) incl"
BOUNDS = "K <= 2 ? 4 : (K == 4 ? 3 : 1)"
# copies: {name: (kernel, {file: [(fragment, replacement)]})}
COPIES = {
    "fused": ("fused", {}),
    "fused_fwd_only": ("fused", {"banded_fused.cu": [
        (FUSED_WALK, FUSED_WALK.replace("k < out_len", "k < 0"))]}),
    "fused_no_dir_stores": ("fused", {"banded_fused.cu": [
        (NIBBLE_STORE, "(void)row;\n      (void)w;")]}),
    "fused_bounds3": ("fused", {"banded_fused.cu": [
        (BOUNDS, BOUNDS.replace("K <= 2 ? 4", "K <= 2 ? 3"))]}),
    "forward": ("forward", {}),
    "forward_bounds3": ("forward", {"banded_forward.cu": [
        (BOUNDS, BOUNDS.replace("K <= 2 ? 4", "K <= 2 ? 3"))]}),
    "forward_no_edge": ("forward", {"banded_row.cuh": [
        (EDGE, EDGE.replace("r <= la", "r <= 0"))]}),
    "forward_no_scan": ("forward", {"banded_row.cuh": [
        (SCAN, SCAN.replace("off = 1;", "off = 32;"))]}),
    "forward_no_dir_stores": ("forward", {"banded_forward.cu": [
        (BYTE_STORE, "(void)row;\n      (void)w;")]}),
}
VARIANTS = {"fused_bounds3", "forward_bounds3"}
# (label, B, n, m, W)
SHAPES = (("search 16,384 x 1,447 x 1,486", 16384, 1447, 1486, 64),
          ("banded main 3,735 x 1,493 x 1,493", 3735, 1493, 1493, 64),
          ("short 16,384 x 200 x 180", 16384, 200, 180, 64),
          ("banded main at W = 128 (four cells a lane)", 3735, 1493, 1493,
           128))

P, LL, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float


def build_copies(build, copies, parent=None):
    """One nvcc per copy, all started together once every copy's sources
    are written; {name: (lib, log)}. Copies named ``parent_*`` are built
    from ``parent``'s sources."""
    out_dir = build.BUILD_DIR / "variants"
    for name, (kind, edits) in copies.items():
        d = out_dir / f"banded_{name}"
        d.mkdir(parents=True, exist_ok=True)
        csrc = (parent / "src" / "repro_torch" / "csrc"
                if name.startswith("parent") else build.CSRC)
        for fname in ("banded_row.cuh", f"banded_{kind}.cu"):
            text = (csrc / fname).read_text()
            for good, bad in edits.get(fname, []):
                if text.count(good) != 1:
                    raise SystemExit(f"banded_variants: {name}: {good!r} "
                                     f"occurs {text.count(good)} times in "
                                     f"{fname}, not once")
                text = text.replace(good, bad)
            (d / fname).write_text(text)
    procs = {}
    for name, (kind, _) in copies.items():
        d = out_dir / f"banded_{name}"
        so = d / f"banded_{kind}.so"
        procs[name] = so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
             str(d / f"banded_{kind}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    logs = {name: proc.communicate()[0] for name, (_, proc) in procs.items()}
    for name, (so, proc) in procs.items():
        if proc.returncode != 0:
            raise SystemExit(f"banded_variants: nvcc failed for {name}:\n"
                             f"{logs[name]}")
    return {name: (ctypes.CDLL(str(so)), logs[name])
            for name, (so, _) in procs.items()}


def entry(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout (git archive <commit> | tar -x "
                         "-C build/parent): its two banded kernels run in "
                         "the same turns, as parent_fused / parent_forward")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("banded_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke as cs
    from flash_variants import ptxas_report
    from repro_torch.core import alphabet as ab
    from repro_torch.kernels import _build
    from repro_torch.kernels.banded import ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    if args.parent is not None:
        COPIES["parent_fused"] = ("fused", {})
        COPIES["parent_forward"] = ("forward", {})
    built = build_copies(_build, COPIES, args.parent)
    filt = Path(_build._nvcc()).parent / "cu++filt"
    for name, (_, log) in built.items():
        print(json.dumps({"copy": name,
                          "ptxas": ptxas_report(log, filt)}))
        for line in log.splitlines():
            if "warning" in line:
                print(f"ptxas {name}: {line.strip()}")
    stream = torch.cuda.current_stream().cuda_stream
    sub = torch.as_tensor(ab.dna_matrix(), dtype=torch.float32,
                          device="cuda")
    S = sub.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def forward_out(dirs, rec):
        i32 = torch.int32
        return ref.BandedForward(dirs, rec[:, 0], rec[:, 1].to(i32),
                                 rec[:, 2].to(i32), rec[:, 3].to(i32),
                                 rec[:, 4] > 0.5)

    def fused_out(rec, a_row, b_row):
        return (rec[:, 0], a_row, b_row, rec[:, 4].to(torch.int32),
                rec[:, 5] > 0.5)

    def call_peak(fn):
        """Device bytes one call allocates above what was in use."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        return peak

    def ctas(name, W):
        """CTAs of the copy's kernel 4 the card holds at once."""
        fn = entry(built[name][0], "banded_fused_attrs", [I, I, P, P, P])
        regs, local, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        _build.check_launch(fn(W, S, ctypes.byref(regs), ctypes.byref(local),
                               ctypes.byref(per_sm)), name)
        return sms * per_sm.value

    def run(name, a, b, lens, W):
        lib = built[name][0]
        B, n = a.shape
        m = b.shape[1]
        head = [a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
                lens.data_ptr(), sub.data_ptr(), S]
        if COPIES[name][0] == "forward":
            fn = entry(lib, "banded_forward", [P, LL, P, LL, P, P, I, P, P, I,
                                               I, I, I, F, F, P])
            dirs = torch.empty((B, n, W), dtype=torch.int8, device="cuda")
            rec = torch.zeros((B, 8), dtype=torch.float32, device="cuda")
            _build.check_launch(fn(*head, dirs.data_ptr(), rec.data_ptr(), B,
                                   n, m, W, 3.0, 1.0, stream), name)
            return forward_out(dirs, rec)
        a_row = torch.empty((B, n + m), dtype=torch.int8, device="cuda")
        b_row = torch.empty((B, n + m), dtype=torch.int8, device="cuda")
        rec = torch.zeros((B, 8), dtype=torch.float32, device="cuda")
        fn = entry(lib, "banded_fused", [P, LL, P, LL, P, P, I, P, P, P, P,
                                         LL, I, I, I, I, F, F, I, I, P])
        plan = ops.fused_plan(B, n, m, W, ctas(name, W))
        work = torch.empty(plan.workspace_bytes, dtype=torch.uint8,
                           device="cuda")
        _build.check_launch(fn(*head, a_row.data_ptr(), b_row.data_ptr(),
                               rec.data_ptr(), work.data_ptr(),
                               plan.workspace_bytes, B, n, m, W, 3.0, 1.0, 5,
                               plan.grid, stream), name)
        return fused_out(rec, a_row, b_row)

    for label, B, n, m, W in SHAPES:
        a, b, lens = cs.banded_inputs(B, n, m, seed=3)
        p3 = ref.banded_forward(a, lens[:, 0], b, lens[:, 1], sub, 3, 1,
                                band=W)
        p4 = (p3.score, *ref.banded_traceback(a, b, p3, 5, band=W))
        runs = list(COPIES)
        times = {r: [] for r in runs}
        exact = {}
        for r in runs + runs[::-1]:
            ms, out = cs.cuda_ms(lambda: run(r, a, b, lens, W))
            times[r].append(ms)
            if COPIES[r][0] == "forward":
                exact[r] = all(torch.equal(getattr(out, f), getattr(p3, f))
                               for f in out._fields)
            else:
                exact[r] = all(torch.equal(x, y) for x, y in zip(out, p4))
            del out
        plan = ops.fused_plan(B, n, m, W, ctas("fused", W))
        for name in runs:
            kernel = name in ("fused", "forward") or name.startswith("parent")
            print(json.dumps({
                "shape": label, "copy": name,
                "kind": ("kernel" if kernel else "variant" if name in VARIANTS
                         else "ablation"),
                "ms": times[name],
                "exact": exact[name],
                "plan": plan._asdict() if name == "fused" else None,
                "call_peak_bytes": call_peak(lambda: run(name, a, b, lens, W))
                if kernel else None}))
        for name in ("fused", "forward"):
            if not exact[name]:
                print(f"banded_variants: {name} differs at {label}")
                return 1
        del a, b, lens, p3, p4
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
