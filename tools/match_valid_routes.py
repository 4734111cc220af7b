#!/usr/bin/env python3
"""Hold every route of the match/valid kernel (kernel 2) exact against its
plain version, time each route at the shapes its callers give it, and
print what ``nvcc -Xptxas -v`` says of each instantiation.

    python3 tools/match_valid_routes.py     # one NVIDIA H100 and nvcc

Builds ``src/repro_torch/csrc/match_valid.cu`` once more with ``-Xptxas
-v`` into ``build/repro_torch/variants/`` and prints one JSON line of
registers, stack and spill bytes per kernel, with any ptxas warning.
Then every case of ``chip_smoke.MV_CASES`` and ``MV_GROUP_CASES``
(a case that differs is printed and the tool exits non-zero at the end),
and one JSON line per timed call (``TIMED``): the kernel, its plain
version, two float32 one-hot products (batched for groups) and
``torch._int_mm`` of the int8 one-hots where it takes the shapes (CUDA
events, 3 runs after a warm-up), with the bound and the route.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from flash_variants import ptxas_report  # noqa: E402

# (label, rows N, rows M or None (symmetric), L, n_chars, gap); "groups":
# (label, "groups", msa rows, L, groups, width)
TIMED = (
    ("main path: distance and SP, symmetric", 4096, None, 6344, 5, 5),
    ("cluster assignment 4,096 x 64", 4096, 64, 6344, 5, 5),
    ("tiled medoid strip 128 x 409", 128, 409, 6344, 5, 5),
    ("tiled assignment strip 128 x 64", 128, 64, 6344, 5, 5),
    ("single column 409 x 1", 409, 1, 6344, 5, 5),
    ("single column 6,553 x 1", 6553, 1, 1440, 5, 5),
    ("stitch at 65,536: 1,024 medoids, symmetric", 1024, None, 1440, 5, 5),
    ("assignment strip at 65,536: 128 x 1,024", 128, 1024, 1440, 5, 5),
    ("protein, symmetric", 1024, None, 2000, 21, 21),
    ("simd route, n_chars 40, symmetric", 1024, None, 2000, 40, 40),
    ("per-cluster batch at 4,096: 55 x 96", "groups", 4096, 6344, 55, 96),
    ("per-cluster batch at 65,536: 1,024 x 96", "groups", 65536, 1440, 1024,
     96),
)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("match_valid_routes: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out / "match_valid_ptxas.so"), str(_build.CSRC / "match_valid.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr)
        return 1
    log = proc.stdout + proc.stderr
    filt = Path(_build._nvcc()).parent / "cu++filt"
    print(json.dumps({"ptxas": ptxas_report(log, filt)}))
    for line in log.splitlines():       # wgmma serialization and the like
        if "warning" in line or "wgmma" in line:
            print(f"ptxas: {line.strip()}")
    _build.build(["match_valid"])

    failed = []
    for i, case in enumerate(cs.MV_CASES):
        try:
            cs.check_mv(*case, seed=40 + i)
        except SystemExit as e:
            print(e)
            failed.append(case)
    for i, case in enumerate(cs.MV_GROUP_CASES):
        try:
            cs.check_mv_groups(*case, seed=60 + i)
        except SystemExit as e:
            print(e)
            failed.append(case)

    for label, *case in TIMED:
        try:
            if case[0] == "groups":
                _, rows, L, G, S = case
                msa, _ = cs.mv_inputs(rows, 1, L, seed=7)
                index = torch.from_numpy(cs.group_index(rows, G, S, 8)).cuda()
                t, _ = cs.time_mv_groups(msa, index, label)
            else:
                n, m, L, n_chars, gap = case
                a, b = cs.mv_inputs(n, m or 1, L, seed=7)
                t, _ = cs.time_mv_inputs(a, None if m is None else b, label,
                                         n_chars=n_chars, gap_code=gap)
        except SystemExit as e:
            print(e)
            failed.append(label)
            continue
        print(json.dumps({"call": label, **t}))
        torch.cuda.empty_cache()
    if failed:
        print(f"match_valid_routes: {len(failed)} failed: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
