#!/usr/bin/env python3
"""Show that ``chip_smoke.py``'s limits for the flash-attention kernel
reject planted faults.

    python3 tools/flash_planted_fault.py      # one NVIDIA H100 and nvcc

Builds copies of ``src/repro_torch/csrc/flash_attention.cu``, each with one
fault in its bf16 tensor-core kernel, into ``build/repro_torch/fault/``
(the source in the tree is not touched): ``window_edge`` drops the
sliding-window mask in the first key tile each q tile visits (up to 64 keys
older than the window leak into a row), ``window_off_by_one`` lets one such
key in, ``p_bf16`` lets only the first bf16 term of the split of p reach
P.V (p rounded to bf16; the reference keeps it in f32), ``diag_unmasked``
classifies the key tile that straddles the causal diagonal as interior, so
it runs unmasked and rows see later keys. On the windowed bf16 and f32
inputs ``chip_smoke.py`` holds the kernel to, it runs the kernel and each
copy through the same wrapper and prints, for each, the largest difference
from the plain version, the excess over ``chip_smoke.py``'s limit and what
the JAX tests' bf16 atol of 2e-2 would have said. Exits non-zero unless the
kernel passes at every shape and each copy fails the limit at some shape.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# each fault: (a fragment of the kernel's code, no comment in it, that
# occurs once in the source; what replaces it)
WINDOW = "if (a.window > 0) ok = ok && pos - kp < a.window;"
FAULTS = {
    "window_edge": (WINDOW, WINDOW.replace("(a.window > 0)",
                                           "(a.window > 0 && k0 != k_begin)")),
    "window_off_by_one": (WINDOW, WINDOW.replace("<", "<=")),
    "p_bf16": ("int P_TERMS = 3;", "int P_TERMS = 1;"),
    "diag_unmasked": ("|| (a.causal && k0 + BK - 1 > pos_lo)", "|| false"),
}
# (B, S, H, KH, D, causal, window, dtype): the serve shape and the windowed
# shapes chip_smoke.py holds
CASES = ((4, 8192, 32, 8, 120, True, 4096, "bfloat16"),
         (1, 8192, 32, 8, 120, True, 4096, "bfloat16"),
         (1, 2048, 32, 8, 120, True, 64, "bfloat16"),
         (1, 2048, 32, 8, 120, False, 64, "bfloat16"),
         (1, 2048, 32, 8, 120, True, 64, "float32"))


def build_copies(build, copies, subdir, flags=()):
    """One nvcc per copy of the kernel's source, all started together;
    ``copies`` maps a name to its [(fragment of code, what replaces it)],
    each fragment found exactly once in the source. Returns {name: (the
    copy's entry point, nvcc's output)}."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    out_dir = build.BUILD_DIR / subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in copies.items():
        text = src
        for good, bad in edits:
            if text.count(good) != 1:
                raise SystemExit(f"{subdir}: {name}: {good!r} occurs "
                                 f"{text.count(good)} times in the source, "
                                 "not once")
            text = text.replace(good, bad)
        cu = out_dir / f"flash_attention_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{subdir}: nvcc failed for {name}:\n{log}")
        fns[name] = ctypes.CDLL(str(so)).flash_attention_fwd, log
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_planted_fault: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    real = ops._lib()
    faults = build_copies(_build, {n: [f] for n, f in FAULTS.items()},
                          "fault")
    fns = {"kernel": real, **{n: fn for n, (fn, _) in faults.items()}}
    for fn in fns.values():
        fn.argtypes, fn.restype = real.argtypes, real.restype
    caught = {name: False for name in FAULTS}
    kernel_ok = True
    for i, (B, S, H, KH, D, causal, window, dt) in enumerate(CASES):
        dtype = getattr(torch, dt)
        q, k, v = cs.flash_inputs(B, S, H, KH, D, dtype, seed=i)
        kw = dict(scale=D ** -0.5, causal=causal, window=window)
        plain32 = cs.flash_plain32(q, k, v, **kw)
        row = dict(shape=[B, S, H, KH, D], causal=causal, window=window,
                   dtype=dt, typical=float(plain32.abs().mean()))
        for name, fn in fns.items():
            ops._lib = lambda fn=fn: fn
            out = ops.attention(q, k, v, **kw)
            err, excess = cs.flash_error(out, plain32)
            row[name] = dict(max_abs_err=err, excess=excess,
                             passes=excess <= 0,
                             passes_atol_2e_2=err <= 2e-2)
            del out
            if name == "kernel":
                kernel_ok &= excess <= 0
            else:
                caught[name] |= excess > 0
        print(json.dumps(row))
        del q, k, v, plain32
        torch.cuda.empty_cache()
    ok = kernel_ok and all(caught.values())
    print(f"flash_planted_fault: kernel passes everywhere: {kernel_ok}; "
          f"faults caught: {json.dumps(caught)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
