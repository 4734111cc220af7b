#!/usr/bin/env python3
"""Time design variants and ablations of the match/valid kernel's
tensor-core route (kernel 2) against the kernel as it is.

    python3 tools/match_valid_variants.py     # one NVIDIA H100 and nvcc

Builds copies of ``src/repro_torch/csrc/match_valid.cu`` into
``build/repro_torch/variants/`` (the source in the tree is not touched),
each with one fragment of code replaced (a fragment, never a comment, that
must occur once in the source): ``VARIANTS`` change a design choice and
must stay exact; ``ABLATIONS`` drop one part of the work, so they are not
exact, and the time each saves is that part's share. Each copy runs the
tensor-core route through its own C entry at ``SHAPES`` in turns (the
kernel, every copy, every copy again in reverse, the kernel; CUDA events,
3 runs each after a warm-up) and prints one JSON line per copy: its times
and, for a variant, whether it equals the plain version.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# each edit: (a fragment of the kernel's code that occurs once; what
# replaces it)
WGMMA_LOOP = "        if (j < steps) {\n          const uint32_t koff"
PLANES = "            wa = plane(ca, q4);\n            wb = plane(cb, q4);"
LOADS = ("      next_a = load16<VEC>(pa, col + CW, p.L);\n"
         "      next_b = load16<VEC>(pb, col + CW, p.L);")
CLASSIFY = ("    classify(ra, live_a, col, p.L, tail, k, ca);\n"
            "    classify(rb, live_b, col, p.L, tail, k, cb);")
VARIANTS = {
    # the first layout: a stage of two swizzle blocks (8 k-steps), 128 KB
    # of shared memory, one CTA an SM
    "one_cta": [("constexpr int STEPS = 4;", "constexpr int STEPS = 8;"),
                ("constexpr int STAGE = 2 * BLK;",
                 "constexpr int STAGE = 4 * BLK;"),
                ("st_shared16(st + BLK + off, wb);",
                 "st_shared16(st + 2 * BLK + off, wb);"),
                ("sw128_desc(st + BLK + koff)", "sw128_desc(st + 2 * BLK + koff)"),
                ("__launch_bounds__(THREADS, 2) tc_kernel",
                 "__launch_bounds__(THREADS, 1) tc_kernel")],
    # small grids split L until they fill two CTAs an SM, not one
    "fill_two": [("plan_split(p, tiles * groups, 1, 4, tc::MAX_CHUNKS)",
                  "plan_split(p, tiles * groups, 2, 4, tc::MAX_CHUNKS)")],
}
ABLATIONS = {
    "no_mma": [(WGMMA_LOOP, WGMMA_LOOP.replace("j < steps", "j < 0"))],
    "no_planes": [(PLANES, "            wa = make_uint4(ca.xp[0], ca.xp[1], "
                           "ca.cnt[2], q4);\n            wb = make_uint4("
                           "cb.xp[0], cb.xp[1], cb.cnt[2], q4);")],
    "no_loads": [(LOADS, "      next_a.x ^= col;\n      next_b.y ^= col;")],
    "no_classify": [(CLASSIFY,
                     "    for (int q = 0; q < 4; ++q) { ca.xp[q] = ca.cnt[q] = "
                     "ca.val[q] = (&ra.x)[q]; cb.xp[q] = cb.cnt[q] = cb.val[q] "
                     "= (&rb.x)[q]; }")],
    "no_expand": [(PLANES, "            wa = make_uint4(q4, q4, q4, q4);\n"
                           "            wb = wa;"), (CLASSIFY, "")],
}
# (label, N, M or None for the symmetric call, L)
SHAPES = (("main path 4,096^2 x 6,344, symmetric", 4096, None, 6344),
          ("assignment 65,536 x 1,024 x 1,440", 65536, 1024, 1440),
          ("medoid strip 128 x 409 x 6,344", 128, 409, 6344),
          ("stitch 1,024^2 x 1,440, symmetric", 1024, None, 1440),
          ("assignment 4,096 x 64 x 6,344", 4096, 64, 6344),
          ("assignment strip 128 x 64 x 6,344", 128, 64, 6344))


def build_copies(build, copies):
    """One nvcc per copy, all started together; {name: (entry, log)}."""
    src = (build.CSRC / "match_valid.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in copies.items():
        text = src
        for good, bad in edits:
            if text.count(good) != 1:
                raise SystemExit(f"match_valid_variants: {name}: {good!r} "
                                 f"occurs {text.count(good)} times, not once")
            text = text.replace(good, bad)
        cu = out_dir / f"match_valid_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"match_valid_variants: nvcc failed for {name}:"
                             f"\n{log}")
        fn = ctypes.CDLL(str(so)).match_valid
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, I, I, I, I, I, P, P, P]
        fn.restype = ctypes.c_int
        fns[name] = fn, log
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("match_valid_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke as cs
    from flash_variants import ptxas_report
    from repro_torch.kernels import _build
    from repro_torch.kernels.distance import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build_copies(_build, {"kernel": [], **VARIANTS, **ABLATIONS})
    filt = Path(_build._nvcc()).parent / "cu++filt"
    for name, (_, log) in built.items():
        tc = [r for r in ptxas_report(log, filt) if "tc_kernel" in r["kernel"]]
        print(json.dumps({"copy": name, "ptxas_tc": tc}))
        for line in log.splitlines():
            if "warning" in line:
                print(f"ptxas {name}: {line.strip()}")
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn, a, b, sym):
        N, M = a.shape[0], b.shape[0]
        out = torch.empty((2, N, M), dtype=torch.int32, device="cuda")
        err = fn(a.data_ptr(), b.data_ptr(), N, M, a.shape[1], 5, 5, int(sym),
                 1, out[0].data_ptr(), out[1].data_ptr(), stream)
        _build.check_launch(err, "match_valid variant")
        return out

    order = list(built)
    turns = order + order[::-1]
    for label, N, M, L in SHAPES:
        a, b = cs.mv_inputs(N, M or 1, L, seed=5)
        sym = M is None
        if sym:
            b = a
        pm, pv = ref.match_valid_ref(a, b, n_chars=5, gap_code=5)
        times = {n: [] for n in order}
        exact = {}
        for name in turns:
            fn = built[name][0]
            ms, out = cs.cuda_ms(lambda: run(fn, a, b, sym))
            times[name].append(ms)
            exact[name] = bool(torch.equal(out[0], pm)
                               and torch.equal(out[1], pv))
            del out
        for name in order:
            print(json.dumps({"shape": label, "copy": name,
                              "kind": "ablation" if name in ABLATIONS
                              else "variant", "ms": times[name],
                              "exact": exact[name]}))
        if not exact["kernel"]:
            print(f"match_valid_variants: the kernel differs at {label}")
            return 1
        del a, b, pm, pv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
