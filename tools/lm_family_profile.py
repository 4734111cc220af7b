#!/usr/bin/env python3
"""Where the time goes in each LM family's prefill and decode on the card.

    python3 tools/lm_family_profile.py      # one NVIDIA H100 and nvcc

Runs each of ``chip_smoke.py``'s phase-21 configurations (mamba2-130m at
4 x 8,192; moonshot at 12 layers, 4 x 2,048; qwen2-vl-2b at 4 x 4,096 on
embeddings; jamba as one group of 8 layers with d_ff 4,096, 2 x 4,096;
kimi as its dense prefix and one MoE layer of 32 experts, 2 x 2,048;
hubert-xlarge's encoder pass at 4 x 4,096), random f32 weights, bf16
compute, through ``make_prefill_step`` / ``make_decode_step`` (hubert:
``apply_model``): one untimed prefill and decode step first, then one
prefill and 3 decode steps under ``torch.profiler`` (CPU and CUDA
activities). Prints one JSON line per family and step kind: the host
wall ms of the profiled window (it ends in a sync), the device ms summed
over its kernels, their share of the wall time (the device's busy share;
the rest is idle, the host dispatching), the number of kernel launches,
and the kernels grouped by kind (GEMM, flash attention, elementwise,
copy/cast, reduction, index/scatter, sort, other) and the 8 largest by
device time. The profiler's own cost inflates the host time a little;
compare shares, not absolute times, with ``chip_smoke.py``'s.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KINDS = (
    ("flash_attention", r"flash|tc::"),
    ("gemm", r"gemm|sm90_xmma|nvjet|cutlass|wgmma|splitK"),
    ("sort", r"sort|radix|Sort"),
    ("index/scatter", r"index|scatter|gather|Index|Scatter|embedding"),
    ("reduction", r"reduce|Reduce|softmax|Softmax|cumsum|scan|topk|"
                  r"bincount|histogram"),
    ("copy/cast", r"copy|Copy|direct_copy|cat|CatArray"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise|"
                    r"pointwise"),
)


def kind_of(name: str) -> str:
    for kind, pat in KINDS:
        if re.search(pat, name):
            return kind
    return "other"


def profile(fn, sync) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    sync()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kind, by_name = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_kind[kind_of(e.name)] += us / 1e3
        by_name[e.name[:90]] += us / 1e3
    busy = sum(by_kind.values())
    return dict(wall_ms=round(wall, 3), device_ms=round(busy, 3),
                busy_share=round(busy / wall, 4) if wall else None,
                launches=len(kernels),
                by_kind={k: round(v, 3) for k, v in
                         sorted(by_kind.items(), key=lambda kv: -kv[1])},
                top=[(n, round(v, 3)) for n, v in
                     sorted(by_name.items(), key=lambda kv: -kv[1])[:8]])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lm_family_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.models import transformer as tt
    from repro_torch.train import serve_step
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    sync = torch.cuda.synchronize
    runs = [(cs.FAMILY_SERVE_ARCH, {}, 4, 8192, 3)] + \
        [(a, c, B, S, 3) for a, c, B, S, _, _ in cs.FAMILY_RUNS]
    for arch, cuts, B, S, n_dec in runs:
        cfg = cs.family_cfg(arch, cuts)
        params = tt.init_params(cfg, 0, device="cuda")
        batch = cs.family_batch(cfg, B, S, "cuda")
        rows = cs.family_batch(cfg, B, n_dec + 1, "cuda", seed=2)
        prefill = serve_step.make_prefill_step(cfg, max_len=S + n_dec + 1)
        decode = serve_step.make_decode_step(cfg)
        state = {}

        def run_prefill():
            state["logits"], state["cache"] = prefill(params, batch)

        def run_decode(steps):
            pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
            for i in range(steps):
                x = (torch.argmax(state["logits"], -1).to(torch.int32)
                     if cfg.embed_input else rows["embeds"][:, i])
                state["logits"], state["cache"] = decode(
                    params, state["cache"], x, pos + i)

        run_prefill()                          # warm-up
        run_decode(1)
        for kind, fn in (("prefill", run_prefill),
                         ("decode x3", lambda: run_decode(n_dec))):
            if kind == "decode x3":
                run_prefill()
            row = profile(fn, sync)
            print(json.dumps({"arch": arch, "cuts": cuts, "batch": B,
                              "prompt": S, "step": kind, **row}),
                  flush=True)
        del params, state, batch, rows
        gc.collect()
        torch.cuda.empty_cache()
    arch, B, S, _ = cs.HUBERT
    cfg = cs.family_cfg(arch, {})
    params = tt.init_params(cfg, 0, device="cuda")
    batch = cs.family_batch(cfg, B, S, "cuda")
    tt.apply_model(params, cfg, batch)
    row = profile(lambda: tt.apply_model(params, cfg, batch), sync)
    print(json.dumps({"arch": arch, "cuts": {}, "batch": B, "prompt": S,
                      "step": "encoder pass", **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
