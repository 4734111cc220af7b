"""MSA launcher on PyTorch: FASTA in, aligned FASTA + tree out.

  PYTHONPATH=src python -m repro_torch.launch.msa_run --fasta in.fa \
      --out out/ [--method kmer] [--tree nj] [--device cuda|cpu]

The same flags and outputs as ``repro.launch.msa_run`` (``aligned.fasta``,
``tree.nwk``, ``report.json``), plus ``--device``: the run is on the card
(``cuda``, the default; it raises when there is none) or, with
``--device cpu``, on the plain PyTorch path. ``report["backend"]`` names
the DP route that ran (``cuda`` = the hand-written kernels, ``torch`` =
their plain versions; ``-banded`` for ``--backend banded|banded-pallas``,
which run the banded forward kernel with ``--band`` columns). ``--tree``
picks the ``repro_torch.phylo.TreeEngine`` backend (``nj`` = dense,
``cluster``, ``tiled``, ``auto``; ``ml`` = the auto backend plus
maximum-likelihood refinement — autodiff branch lengths, BIC model
selection, NNI — which adds the model and logL before/after to the
report); ``--tree-ll`` adds the tree's JC69 log-likelihood.

``--dist [--mesh DxM]`` routes the alignment through
``repro_torch.dist.mapreduce.msa_over_mesh`` (the reference's mesh
semantics: banded backends take the band's result with no per-pair
fallback, and ``kmer_fallbacks`` is null), and the tree stage's tiled
strips, bootstrap and fleet scoring split over the same mesh. It runs
one process a rank: under ``torchrun`` (``WORLD_SIZE`` set) on the
``nccl`` backend for ``cuda`` and ``gloo`` for ``cpu``, in a process
group the caller already made, or alone as a world of one. Every rank
computes the same result; rank 0 writes the files.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.msa_run",
        description="MSA launcher (PyTorch/CUDA port): FASTA in, aligned "
                    "FASTA + tree out")
    ap.add_argument("--fasta", required=True)
    ap.add_argument("--out", default="msa_out")
    ap.add_argument("--method", default="kmer",
                    choices=["kmer", "plain", "sw"])
    ap.add_argument("--alphabet", default="dna",
                    choices=["dna", "rna", "protein"])
    ap.add_argument("--tree", default="nj",
                    choices=["nj", "cluster", "tiled", "auto", "ml", "none"],
                    help="tree backend (repro_torch.phylo registry; nj = "
                         "dense; ml = auto backend + ML refinement)")
    ap.add_argument("--cluster-threshold", type=int, default=64,
                    help="N at or below which cluster/auto tree backends "
                         "fall back to dense NJ")
    ap.add_argument("--tree-ll", action="store_true",
                    help="record the tree's JC69 log-likelihood in the "
                         "report (DNA/RNA only)")
    ap.add_argument("--k", type=int, default=11)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "jnp", "pallas", "banded",
                             "banded-pallas"],
                    help="map(1) DP backend; auto/jnp/pallas run the "
                         "full DP, banded/banded-pallas the banded "
                         "forward kernel, on the device's route")
    ap.add_argument("--band", type=int, default=64,
                    help="band width for the banded backends")
    ap.add_argument("--dist", action="store_true",
                    help="run the mesh pipeline (repro_torch.dist."
                         "mapreduce), one process a rank")
    ap.add_argument("--mesh", default=None,
                    help="data x model for --dist, e.g. 4x1; default: "
                         "every rank x 1")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) "
                         "or on the plain PyTorch path on the CPU")
    from ..obs import export as obs_export
    obs_export.add_output_args(ap)
    return ap


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.tree == "ml" and args.alphabet == "protein":
        parser.error("--tree ml needs a nucleotide alphabet (the 4-state "
                     "likelihood); use --tree cluster/tiled for protein")
    if args.dist and args.tree == "ml":
        # on a mesh the ML fit runs under deterministic algorithms; cuBLAS
        # reads its workspace configuration once, when it starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from ..device import resolve_device
    resolve_device(args.device)
    from ..obs import export as obs_export
    from ..obs import trace as _trace
    from .mesh import run_on_mesh
    with run_on_mesh(args.dist, args.mesh, args.device) as mesh:
        with _trace.request_trace(), _trace.span("msa_run",
                                                 fasta=args.fasta):
            _run(args, mesh)
        if mesh is None or mesh.rank == 0:
            obs_export.write_outputs(args)


def _run(args, mesh=None):
    from ..obs import trace as _trace
    with _trace.span("load"):
        import torch

        from ..align import resolve_backend
        from ..core import alphabet as ab
        from ..core import likelihood, sp_score
        from ..core.msa import MSAConfig, center_star_msa, decode_msa
        from ..data import read_fasta, write_fasta
        names, seqs = read_fasta(args.fasta)

    dev = torch.device(args.device)
    alpha = {"dna": ab.DNA, "rna": ab.RNA, "protein": ab.PROTEIN}[args.alphabet]
    cfg = MSAConfig(method=args.method, alphabet=args.alphabet, k=args.k,
                    gap_open=11 if args.alphabet == "protein" else 3,
                    backend=args.backend, band=args.band)
    writer = mesh is None or mesh.rank == 0
    t0 = time.time()
    if mesh is not None:
        from ..dist import mapreduce
        res = mapreduce.msa_over_mesh(seqs, cfg, mesh)
    else:
        res = center_star_msa(seqs, cfg, device=dev)
    t_msa = time.time() - t0
    out = Path(args.out)
    with _trace.span("write", out=str(out)):
        if writer:
            out.mkdir(parents=True, exist_ok=True)
            write_fasta(out / "aligned.fasta", names,
                        decode_msa(res.msa, cfg))

    with _trace.span("score"):
        msa = torch.as_tensor(res.msa, device=dev)
        sp = float(sp_score.avg_sp(msa, gap_code=alpha.gap_code,
                                   n_chars=alpha.n_chars))
    report = {"n_sequences": len(seqs), "width": res.width,
              "center": names[res.center_idx],
              "center_mode": res.center_mode,
              "backend": resolve_backend(args.backend, dev),
              "avg_sp_penalty": sp,
              # null under --dist: per-pair fallbacks aren't counted there
              "kmer_fallbacks": res.n_fallback if res.n_fallback >= 0
              else None,
              "msa_seconds": t_msa}

    if args.tree != "none":
        from ..phylo import TreeEngine
        t0 = time.time()
        engine = TreeEngine(gap_code=alpha.gap_code, n_chars=alpha.n_chars,
                            correct=args.alphabet != "protein",
                            backend={"nj": "dense", "ml": "auto"}.get(
                                args.tree, args.tree),
                            cluster_threshold=args.cluster_threshold,
                            mesh=mesh,
                            refine="ml" if args.tree == "ml" else "none",
                            device=args.device)
        tree_res = engine.build(msa)
        report["tree_seconds"] = time.time() - t0
        report["tree_backend"] = tree_res.backend
        if tree_res.logl is not None:
            report["tree_model"] = tree_res.model
            report["tree_logl"] = tree_res.logl
        if tree_res.tile_stats is not None:
            report["tile_stats"] = tree_res.tile_stats
        nwk = tree_res.newick(names)
        with _trace.span("write", artifact="tree.nwk"):
            if writer:
                (out / "tree.nwk").write_text(nwk + "\n")
        if args.tree_ll and args.alphabet != "protein":
            with _trace.span("loglik"):
                report["log_likelihood"] = float(likelihood.log_likelihood(
                    msa, tree_res.children, tree_res.blen, tree_res.root,
                    gap_code=alpha.gap_code))

    if writer:
        with _trace.span("report"):
            (out / "report.json").write_text(json.dumps(report, indent=1))
        print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
