#!/usr/bin/env python3
"""Time ``tree_run`` of two checkouts of the port on the same card, in turns.

    python3 tools/tree_ab.py OTHER_ROOT [--n 65536] [--backends cluster tiled]

Simulates ``--n`` aligned Phi_RNA-shaped rows once (``chip_smoke.simulate``,
no indels) and runs ``repro_torch.launch.tree_run --backend B`` on them from
OTHER_ROOT (for example a ``git archive`` of the parent commit unpacked
under ``build/``) and from this checkout, in the order other, this, this,
other for each backend; each run is a fresh process (its kernels built
first, outside the timed run). Prints one JSON line per run: the checkout,
the backend, the tree's stage seconds (host clock, spans ending in a device
sync), its kernel-2 launches and a digest of the Newick, which must be
equal between the two checkouts (the trees are bitwise equal).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("load", "tree.medoids", "tree.assign", "tree.cluster_nj",
          "tree.stitch", "tree", "write", "tree_run")

# runs inside the checkout's own interpreter: build the kernels, then one
# tree_run with the launch count reset just before it
CHILD = """
import hashlib, json, sys
from pathlib import Path
from repro_torch.kernels import _build
from repro_torch.kernels.distance import ops
from repro_torch.launch import tree_run
from repro_torch.obs import trace
import torch
_build.build()
fasta, out, backend = sys.argv[1:4]
trace.TRACER.clear()
ops.launches = 0
tree_run.main(["--fasta", fasta, "--out", out, "--backend", backend])
torch.cuda.synchronize()
stages = {}
for rec in trace.TRACER.spans():
    stages[rec.name] = stages.get(rec.name, 0.0) + rec.duration
nwk = (Path(out) / "tree.nwk").read_bytes()
print(json.dumps({"stages": stages, "launches": ops.launches,
                  "newick_sha256": hashlib.sha256(nwk).hexdigest()}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--backends", nargs="+", default=["cluster", "tiled"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tree_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.data import write_fasta

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    work = ROOT / "build" / "tree_ab"
    work.mkdir(parents=True, exist_ok=True)
    fam = cs.simulate(args.n, indel=0.0)
    fasta = work / f"phi_rna_{args.n}_aligned.fa"
    write_fasta(fasta, fam.names, fam.seqs)
    del fam
    roots = {"other": args.other.resolve(), "this": ROOT}
    digests = {}
    for backend in args.backends:
        for who in ("other", "this", "this", "other"):
            root = roots[who]
            out = work / f"{who}_{backend}"
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, str(fasta), str(out), backend],
                cwd=root, env=dict(os.environ, PYTHONPATH=str(root / "src")),
                capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout[-2000:] + proc.stderr[-4000:])
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            digests.setdefault(backend, set()).add(res["newick_sha256"])
            print(json.dumps({"checkout": who, "backend": backend,
                              "launches": res["launches"],
                              "stages": {k: res["stages"].get(k, 0.0)
                                         for k in STAGES}}))
    for backend, d in digests.items():
        if len(d) != 1:
            print(f"tree_ab: the {backend} trees differ between checkouts")
            return 1
    print("tree_ab: each backend's Newick is equal between the checkouts")
    return 0


if __name__ == "__main__":
    sys.exit(main())
