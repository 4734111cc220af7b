#!/usr/bin/env python3
"""Time the Gotoh forward kernel (kernel 1) beside design variants and
with parts of its work cut out, at the four shapes its paths send.

    python3 tools/sw_variants.py                      # one NVIDIA H100 and nvcc
    python3 tools/sw_variants.py --parent build/parent

Builds copies of ``src/repro_torch/csrc/sw_forward.cu`` into
``build/repro_torch/variants/`` (the source in the tree is not touched),
each with fragments of code replaced (a fragment, never a comment, that
must occur once in the file), and prints each copy's ``nvcc -Xptxas -v``
registers and spills. ``VARIANTS`` change a design choice and must stay
exact: ``max_c4``, ``max_c8`` and ``max_c16`` (at most 4, 8 or 16
columns a lane, not 12: more strips of fewer columns, or fewer of more;
at 16 a 32 x 32 table's profile no longer fits in shared memory),
``warps8`` (8 pairs a CTA), ``min3`` and ``min5`` (3 or 5 CTAs an SM in
``__launch_bounds__``, not 4: at most 170 or 102 registers), ``wb_stores`` (the
direction bytes stored write-back, not streaming), ``direct_all`` and
``staged_all`` (the direction bytes stored one by one from registers, or
through the row stage, at every C; the kernel takes the first at C <= 4,
the second above). The others drop one part of the work, so they are not
exact, and the time each saves is that part's share: ``no_dir_stores``
(no direction byte written to device memory), ``no_scan`` (no warp
max-scan for Iy), ``no_row_sync`` (no __syncwarp between a row's stage
writes and reads: a race, so it may differ). Each copy runs through its
own C entries (its grid from its own occupancy, its workspace from its
own ``sw_slot_bytes``) at ``SHAPES`` in turns (the kernel, every copy,
every copy again in reverse, the kernel; CUDA events, 3 runs each after a
warm-up; the exactness check is one more call into outputs filled with a
sentinel) in the shape's path mode; the kernel also runs the local shape
in global mode (the local best's share is the difference). One JSON line
per copy and shape: its times, whether it equals the plain version, its
grid and workspace, and for the kernels the device bytes one call
allocates above what was in use (output and workspace). ``--parent DIR``
adds another checkout's kernel 1 (the first design's C entry: a CTA a
pair, no workspace) to the turns as ``parent``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

DIR_STORE = ("__stcs(gw + 32 * k, __funnelshift_r(s32[32 * k], "
             "s32[32 * k + 1], 8 * hb));")
BYTE_STORE = "if (part) __stcs(reinterpret_cast<signed char*>(g + x), pb);"
DIRECT_STORE = ("__stcs(reinterpret_cast<signed char*>(g + c),\n"
                "                       (signed char)__float_as_uint(__fadd_rn(v[c], "
                "MAGIC)));")
ROW_SYNC = "__syncwarp();\n            // the row's strip segment"
STAGE_FROM = "if constexpr (C <= 4) {"
SCAN = "for (int off = 1; off < 32; off <<= 1) T = fmaxf"
MAX_C = "constexpr int MAX_C = 12;"
WARPS = "constexpr int WARPS = 4;"
BOUNDS = "__launch_bounds__(WARPS * 32, 4)"
# copies: {name: [(fragment, replacement)]}
COPIES = {
    "kernel": [],
    "max_c4": [(MAX_C, MAX_C.replace("12", "4"))],
    "max_c8": [(MAX_C, MAX_C.replace("12", "8"))],
    "max_c16": [(MAX_C, MAX_C.replace("12", "16"))],
    "warps8": [(WARPS, WARPS.replace("4", "8"))],
    "min3": [(BOUNDS, "__launch_bounds__(WARPS * 32, 3)")],
    "min5": [(BOUNDS, "__launch_bounds__(WARPS * 32, 5)")],
    "wb_stores": [(DIR_STORE, DIR_STORE.replace("__stcs", "__stwb")),
                  (BYTE_STORE, BYTE_STORE.replace("__stcs", "__stwb"))],
    "no_dir_stores": [(DIR_STORE, "(void)s32;"), (BYTE_STORE, "(void)pb;"),
                      (DIRECT_STORE, "(void)g;")],
    "direct_all": [(STAGE_FROM, STAGE_FROM.replace("4", "16"))],
    "staged_all": [(STAGE_FROM, STAGE_FROM.replace("4", "0"))],
    "no_row_sync": [(ROW_SYNC, "// the row's strip segment")],
    "no_scan": [(SCAN, SCAN.replace("off = 1;", "off = 32;"))],
}
VARIANTS = {"max_c4", "max_c8", "max_c16", "warps8", "min3", "min5",
            "wb_stores",
            "direct_all", "staged_all"}
# (label, B, n, m, broadcast target, local): the largest call of each path
SHAPES = (
    ("main: map1 failed chains 3,735 x 1,493 x 1,493", 3735, 1493, 1493,
     True, False),
    ("main: segments 15,951 x 64 x 64", 15951, 64, 64, False, False),
    ("search local chunk 3,989 x 1,447 x 1,486", 3989, 1447, 1486, False,
     True),
    ("ml: segments 53,761 x 64 x 64", 53761, 64, 64, False, False),
)

P, LL, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float


def build_copies(build, copies, parent=None):
    """One nvcc per copy, all started together; {name: (lib, log)}. The
    copy ``parent`` is built from ``parent``'s source."""
    out_dir = build.BUILD_DIR / "variants"
    procs = {}
    for name, edits in copies.items():
        d = out_dir / f"sw_{name}"
        d.mkdir(parents=True, exist_ok=True)
        csrc = (parent / "src" / "repro_torch" / "csrc" if name == "parent"
                else build.CSRC)
        text = (csrc / "sw_forward.cu").read_text()
        for good, bad in edits:
            if text.count(good) != 1:
                raise SystemExit(f"sw_variants: {name}: {good!r} occurs "
                                 f"{text.count(good)} times, not once")
            text = text.replace(good, bad)
        (d / "sw_forward.cu").write_text(text)
        so = d / "sw_forward.so"
        procs[name] = so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
             str(d / "sw_forward.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"sw_variants: nvcc failed for {name}:\n{log}")
        built[name] = ctypes.CDLL(str(so)), log
    return built


def entry(lib, name, argtypes, restype=ctypes.c_int):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout (git archive <commit> | tar -x "
                         "-C build/parent) with the first design's C entry: "
                         "its kernel 1 runs in the same turns, as parent")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sw_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke as cs
    from flash_variants import ptxas_report
    from repro_torch.core import alphabet as ab
    from repro_torch.kernels import _build
    from repro_torch.kernels.sw import ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    if args.parent is not None:
        COPIES["parent"] = []
    built = build_copies(_build, COPIES, args.parent)
    filt = Path(_build._nvcc()).parent / "cu++filt"
    for name, (_, log) in built.items():
        print(json.dumps({"copy": name, "ptxas": ptxas_report(log, filt)}))
        for line in log.splitlines():
            if "warning" in line:
                print(f"ptxas {name}: {line.strip()}")
    stream = torch.cuda.current_stream().cuda_stream
    sub = torch.as_tensor(ab.dna_matrix(), dtype=torch.float32,
                          device="cuda")
    S = sub.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def plan(name, B, n, m, local):
        """(grid, workspace bytes) of a copy from its own entries."""
        lib = built[name][0]
        regs, lb, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        _build.check_launch(entry(lib, "sw_forward_attrs",
                                  [I, I, I, P, P, P])(
            m, int(local), S, ctypes.byref(regs), ctypes.byref(lb),
            ctypes.byref(per_sm)), name)
        warps = 8 if name == "warps8" else ops.PAIRS_PER_CTA
        grid = max(1, min(-(-B // warps), sms * per_sm.value))
        slot = entry(lib, "sw_slot_bytes", [I, I], ctypes.c_longlong)(n, m)
        return grid, grid * warps * slot

    def run(name, a, b, lens, local, fill=False):
        """One call of a copy; ``fill``: outputs start as a sentinel, so a
        byte the copy does not write shows (the timed calls start from
        whatever the allocator hands out)."""
        lib = built[name][0]
        B, n = a.shape
        m = b.shape[1]
        dirs = torch.empty((B, n + 1, m + 1), dtype=torch.int8,
                           device="cuda")
        rec = torch.empty((B, 8), dtype=torch.float32, device="cuda")
        if fill:
            dirs.fill_(0x55)
            rec.fill_(float("nan"))
        head = [a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
                lens.data_ptr(), sub.data_ptr(), S, dirs.data_ptr(),
                rec.data_ptr()]
        if name == "parent":
            fn = entry(lib, "sw_forward", [P, LL, P, LL, P, P, I, P, P, I, I,
                                           I, F, F, I, P])
            err = fn(*head, B, n, m, 3.0, 1.0, int(local), stream)
        else:
            grid, nbytes = plan(name, B, n, m, local)
            work = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
            fn = entry(lib, "sw_forward", [P, LL, P, LL, P, P, I, P, P, P, LL,
                                           I, I, I, F, F, I, I, P])
            err = fn(*head, work.data_ptr(), nbytes, B, n, m, 3.0, 1.0,
                     int(local), grid, stream)
        _build.check_launch(err, name)
        return dirs[:, 1:], rec

    bad = []
    for label, B, n, m, broadcast, local in SHAPES:
        a, b, lens = cs.sw_inputs(B, n, m, seed=5, broadcast=broadcast)
        turns = [(name, local) for name in COPIES]
        if local:
            turns.append(("kernel", False))          # global only
        times = {t: [] for t in turns}
        exact = {}
        plains = {}
        for md in sorted({md for _, md in turns}):
            plains[md] = ref.gotoh_forward_ref(a, b, lens, sub, gap_open=3,
                                               gap_extend=1, local=md)
        for t in turns + turns[::-1]:
            ms, out = cs.cuda_ms(lambda: run(t[0], a, b, lens, t[1]))
            times[t].append(ms)
            del out
        for t in turns:
            out = run(t[0], a, b, lens, t[1], fill=True)
            p = plains[t[1]]
            exact[t] = bool(torch.equal(out[0], p[0])
                            and torch.equal(out[1], p[1]))
            del out
        for (name, md) in turns:
            kernel = name in ("kernel", "parent")
            grid, nbytes = (plan(name, B, n, m, md) if name != "parent"
                            else (B, 0))
            print(json.dumps({
                "shape": label, "copy": name, "local": md,
                "kind": ("kernel" if kernel else "variant" if name in VARIANTS
                         else "ablation"),
                "ms": times[(name, md)], "exact": exact[(name, md)],
                "grid": grid, "workspace_bytes": nbytes,
                "call_peak_bytes": cs.call_peak(
                    lambda: run(name, a, b, lens, md)) if kernel else None}))
            if (kernel or name in VARIANTS) and not exact[(name, md)]:
                bad.append(f"{name} local={md} at {label}")
        del a, b, lens, plains
        torch.cuda.empty_cache()
    if bad:
        print(f"sw_variants: not exact: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
