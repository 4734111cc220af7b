#!/usr/bin/env python3
"""Time design variants of the flash-attention kernel's bf16 path against
the kernel as it is, and print what ``nvcc -Xptxas -v`` says of each
instantiation.

    python3 tools/flash_variants.py      # one NVIDIA H100 and nvcc

Builds copies of ``src/repro_torch/csrc/flash_attention.cu``, each with one
design choice changed, into ``build/repro_torch/variants/`` (the source in
the tree is not touched): ``terms2`` splits p into two bf16 terms instead
of three, ``bq128`` gives a CTA two warpgroups (128 query rows sharing each
K/V tile), ``stages3`` keeps three K/V tiles in the ring, ``fast_exp``
takes p from the approximate ``__expf``.
Ablations drop one part of the work and fail the limit by design; the time
each saves is that part's share: ``terms1`` (P.V with one term: p rounded
to bf16), ``no_exp``, ``no_qk``, ``no_pv``, ``no_mma`` (both products),
``no_copy`` (no K/V copies) and ``no_copy_mma``. The kernel itself is built
once more with ``-Xptxas -v``: its registers, stack and spill bytes are
printed for every kernel of the file, with any ptxas warning. Each variant
is held to ``chip_smoke.py``'s bf16 limit at every bf16 shape of its
``flash_cases`` and timed at the serve shape (4 x 8,192 x 32 heads of 120
over 8 KV heads, causal, window 4,096), in turns: the kernel, every
variant, every variant again in reverse, the kernel (CUDA events, 5 runs
each after a warm-up). Prints one JSON line for the registers, one per
variant (its times, its largest excess over the limit), then
``chip_smoke.time_flash``'s line (the kernel beside its plain version and
SDPA in the same call); exits non-zero if the kernel fails the limit
anywhere (a variant that fails is a finding, printed as such).
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from flash_planted_fault import build_copies  # noqa: E402

# each edit: (a fragment of the kernel's code, no comment in it, that occurs
# once in the source; what replaces it)
TERMS = "int P_TERMS = 3;"
EXP = "const float p = expf(s[j][e] - mu[e >> 1]);"
VARIANTS = {
    "terms2": [(TERMS, TERMS.replace("= 3;", "= 2;"))],
    "bq128": [("int WARPS = 4;", "int WARPS = 8;")],
    "stages3": [("int STAGES = 2;", "int STAGES = 3;")],
    "fast_exp": [(EXP, EXP.replace("expf(", "__expf("))],
}
# ablations: each drops one part of the work, so it fails the limit by
# design; the time it saves is that part's share
NO_QK = [("kk < KT;", "kk < 0;")]
NO_PV = [("nb < DP / 128;", "nb < 0;")]
NO_COPY = [("mbar_expect(&bars[st], 2 * BK * DP * (int)sizeof(bf16));",
            "mbar_expect(&bars[st], 0);"),
           ("cb < DP / 64;", "cb < 0;")]
ABLATIONS = {
    "terms1": [(TERMS, TERMS.replace("= 3;", "= 1;"))],
    "no_exp": [(EXP, EXP.replace("expf(s[j][e] - mu[e >> 1])",
                                 "s[j][e] - mu[e >> 1]"))],
    "no_qk": NO_QK,
    "no_pv": NO_PV,
    "no_mma": NO_QK + NO_PV,
    "no_copy": NO_COPY,
    "no_copy_mma": NO_COPY + NO_QK + NO_PV,
}
SERVE = (4, 8192, 32, 8, 120, True, 4096)


def ptxas_report(log: str, filt: Path):
    """[{kernel, registers, stack, spill_stores, spill_loads}] from the
    output of ``nvcc -Xptxas -v``, kernel names demangled by ``filt``
    (``cu++filt``) where it exists."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows.append(dict(kernel=name, stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3))))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["kernel"] == name:
            rows[-1]["registers"] = int(m.group(1))
    if filt.exists() and rows:
        names = "\n".join(r["kernel"] for r in rows)
        out = subprocess.run([str(filt)], input=names, capture_output=True,
                             text=True).stdout.split("\n")
        for r, d in zip(rows, out):
            r["kernel"] = d.strip() or r["kernel"]
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    built = build_copies(_build, {"kernel": [], **VARIANTS, **ABLATIONS},
                         "variants", flags=("-Xptxas", "-v"))
    log = built["kernel"][1]
    filt = Path(_build._nvcc()).parent / "cu++filt"
    print(json.dumps({"ptxas": ptxas_report(log, filt)}))
    for line in log.splitlines():       # wgmma serialization and the like
        if "warning" in line or "wgmma" in line:
            print(f"ptxas: {line.strip()}")
    real = ops._lib()
    fns = {"kernel": real, **{n: fn for n, (fn, _) in built.items()
                              if n != "kernel"}}
    for fn in fns.values():
        fn.argtypes, fn.restype = real.argtypes, real.restype

    def run(fn, q, k, v, **kw):
        ops._lib = lambda: fn
        try:
            return ops.attention(q, k, v, **kw)
        finally:
            ops._lib = lambda: real

    worst = {n: float("-inf") for n in fns}
    for i, c in enumerate(cs.flash_cases()):
        B, S, H, KH, D, causal, window, dtype = c[:8]
        extra = c[8] if len(c) > 8 else {}
        if dtype != torch.bfloat16 or extra.get("bhsd") or \
                extra.get("shared_kv"):
            continue
        q, k, v = cs.flash_inputs(B, S, H, KH, D, dtype, seed=i,
                                  T=extra.get("T"))
        kw = dict(scale=D ** -0.5, causal=causal, window=window,
                  q_offset=extra.get("q_offset", 0))
        plain32 = cs.flash_plain32(q, k, v, **kw)
        for name, fn in fns.items():
            try:
                _, excess = cs.flash_error(run(fn, q, k, v, **kw), plain32)
            except RuntimeError as e:      # a launch the variant refuses
                print(f"{name} at {c[:8]}: {e}")
                excess = float("inf")
            worst[name] = max(worst[name], excess)
        del q, k, v, plain32
    torch.cuda.empty_cache()

    B, S, H, KH, D, causal, window = SERVE
    q, k, v = cs.flash_inputs(B, S, H, KH, D, torch.bfloat16, seed=99)
    kw = dict(scale=D ** -0.5, causal=causal, window=window)
    plain32 = cs.flash_plain32(q, k, v, **kw)
    order = list(fns)
    order = order + order[1:][::-1] + order[:1]
    ms = {n: [] for n in fns}
    for name in order:
        t, out = cs.cuda_ms(lambda: run(fns[name], q, k, v, **kw), reps=5)
        ms[name].append(t)
        worst[name] = max(worst[name], cs.flash_error(out, plain32)[1])
        del out
    for name in fns:
        print(json.dumps(dict(variant=name, ablation=name in ABLATIONS,
                              ms=ms[name],
                              mean_ms=sum(ms[name]) / len(ms[name]),
                              worst_excess=worst[name],
                              passes=worst[name] <= 0)))
    del q, k, v, plain32
    torch.cuda.empty_cache()
    cs.time_flash()
    within = {n: w <= 0 for n, w in worst.items() if n not in ABLATIONS}
    print(f"flash_variants: within the limit: {json.dumps(within)}")
    return 0 if worst["kernel"] <= 0 else 1


if __name__ == "__main__":
    sys.exit(main())
