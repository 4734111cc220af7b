"""Tree reconstruction from an already-aligned FASTA, on PyTorch.

  PYTHONPATH=src python -m repro_torch.launch.tree_run \
      --fasta aligned.fasta --out tree_out/ --backend tiled \
      [--row-block 128] [--tree-ll] [--device cuda|cpu] \
      [--refine ml --model auto --bootstrap 100] \
      [--refine search --starts 4 --restartable [--resume]]

The same flags and outputs as ``repro.launch.tree_run`` (``tree.nwk``,
with per-edge bootstrap support labels when ``--bootstrap`` ran, and
``report.json``: effective backend, tree seconds, for the tiled backends
the tile accountant's memory stats, with ``--tree-ll`` the JC69
log-likelihood, for ``--refine ml``/``search`` the selected model,
per-model BIC and logL before/after, for ``search`` the per-start
trajectories and move counts), plus ``--device``: the run is on the card
(``cuda``, the default; it raises when there is none) or, with
``--device cpu``, on the plain PyTorch path. The distance counts go
through the match/valid kernel on the card.

``--dist`` / ``--mesh DxM`` run on a mesh of ranks, one process a rank
as ``repro_torch.launch.msa_run --dist`` runs: the tiled backend's
distance strips and assignment, ML bootstrap replicates and the search
fleet's candidate scoring split over it (``--mesh`` alone builds it too,
so bootstrap and the fleet split, and ``--backend auto`` picks tiled on
more than one rank). Every rank computes the same tree; rank 0 writes the
files and the search's checkpoints.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.tree_run",
        description="tree reconstruction from an already-aligned FASTA "
                    "(PyTorch/CUDA port)")
    ap.add_argument("--fasta", required=True,
                    help="aligned FASTA (equal-width rows, '-' for gaps)")
    ap.add_argument("--out", default="tree_out")
    ap.add_argument("--alphabet", default="dna",
                    choices=["dna", "rna", "protein"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "dense", "tiled", "cluster"],
                    help="tree backend (repro_torch.phylo registry)")
    ap.add_argument("--cluster-threshold", type=int, default=64,
                    help="N at or below which cluster/auto fall back to "
                         "dense NJ")
    ap.add_argument("--row-block", type=int, default=128,
                    help="tile row-block: the tiled backend's distance "
                         "budget is row_block * N * 4 bytes")
    ap.add_argument("--target-cluster", type=int, default=64,
                    help="desired leaves per HPTree cluster")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree-ll", action="store_true",
                    help="also score the tree by JC69 log-likelihood "
                         "(DNA/RNA only)")
    ap.add_argument("--refine", default="none",
                    choices=["none", "ml", "search"],
                    help="ml = single-start ML refinement "
                         "(repro_torch.phylo.ml), search = the "
                         "multi-start NNI+SPR fleet "
                         "(repro_torch.phylo.treesearch); DNA/RNA only")
    ap.add_argument("--model", default="auto",
                    choices=["auto", "jc69", "k80", "hky85", "gtr"],
                    help="substitution model for --refine ml/search "
                         "(auto = select by BIC)")
    ap.add_argument("--bootstrap", type=int, default=0,
                    help="bootstrap replicates for per-edge support "
                         "labels (0 = off; requires --refine ml or "
                         "search)")
    ap.add_argument("--ml-steps", type=int, default=150,
                    help="adam steps per ML branch-length/model fit")
    ap.add_argument("--nni-rounds", type=int, default=8,
                    help="max accepted NNI rounds for --refine ml")
    ap.add_argument("--starts", type=int, default=4,
                    help="fleet size K for --refine search (start "
                         "topologies: NJ, cluster-medoid, random "
                         "stepwise addition)")
    ap.add_argument("--spr-radius", type=int, default=3,
                    help="SPR regraft radius (hops from the prune wound) "
                         "for --refine search")
    ap.add_argument("--search-rounds", type=int, default=12,
                    help="max move rounds per search for --refine search")
    ap.add_argument("--restartable", action="store_true",
                    help="checkpoint the search fleet per round (to "
                         "--ckpt-dir, default <out>/search_ckpt); a "
                         "killed run resumes bit-identically with "
                         "--resume")
    ap.add_argument("--ckpt-dir", default=None,
                    help="search checkpoint directory (implies "
                         "--restartable)")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed --restartable search from its "
                         "newest checkpoint")
    ap.add_argument("--dist", action="store_true",
                    help="split the distance strips over the mesh")
    ap.add_argument("--mesh", default=None,
                    help="data x model mesh, e.g. 4x1 — builds the mesh "
                         "even without --dist (splitting ML bootstrap "
                         "replicates and the search fleet's scoring, and "
                         "letting backend=auto pick tiled); with --dist "
                         "alone: every rank x 1")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) "
                         "or on the plain PyTorch path on the CPU")
    from ..obs import export as obs_export
    obs_export.add_output_args(ap)
    return ap


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.bootstrap > 0 and args.refine == "none":
        parser.error("--bootstrap requires --refine ml or search")
    if args.refine != "none" and args.alphabet == "protein":
        parser.error(f"--refine {args.refine} needs a nucleotide alphabet "
                     "(the 4-state likelihood)")
    if args.resume and not (args.restartable or args.ckpt_dir):
        parser.error("--resume requires --restartable (or --ckpt-dir)")
    if (args.restartable or args.ckpt_dir) and args.refine != "search":
        parser.error("--restartable/--ckpt-dir apply to --refine search")
    on_mesh = args.dist or args.mesh is not None
    if args.refine == "search" or (on_mesh and args.refine != "none"):
        # the search (and on a mesh the ML fit) runs under deterministic
        # algorithms; cuBLAS reads its workspace configuration once, when
        # it starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from ..device import resolve_device
    resolve_device(args.device)
    from ..obs import export as obs_export
    from ..obs import trace as _trace
    from .mesh import run_on_mesh
    with run_on_mesh(on_mesh, args.mesh, args.device) as mesh:
        with _trace.request_trace(), _trace.span("tree_run",
                                                 fasta=args.fasta):
            _run(args, mesh)
        if mesh is None or mesh.rank == 0:
            obs_export.write_outputs(args)


def _run(args, mesh=None):
    from ..obs import trace as _trace
    with _trace.span("load"):
        import numpy as np
        import torch

        from ..core import alphabet as ab
        from ..core import likelihood
        from ..data import read_fasta
        from ..phylo import TreeEngine
        names, seqs = read_fasta(args.fasta)
        widths = {len(s) for s in seqs}
        if len(widths) != 1:
            raise ValueError(
                f"{args.fasta} is not aligned (row widths "
                f"{sorted(widths)[:5]}...); run repro_torch.launch.msa_run "
                "first")
        alpha = {"dna": ab.DNA, "rna": ab.RNA,
                 "protein": ab.PROTEIN}[args.alphabet]
        msa = torch.from_numpy(alpha.encode_aligned_rows(seqs)).to(
            args.device)

    ckpt_dir = args.ckpt_dir
    if args.restartable and ckpt_dir is None:
        ckpt_dir = str(Path(args.out) / "search_ckpt")
    engine = TreeEngine(gap_code=alpha.gap_code, n_chars=alpha.n_chars,
                        correct=args.alphabet != "protein",
                        backend=args.backend,
                        cluster_threshold=args.cluster_threshold,
                        row_block=args.row_block,
                        target_cluster=args.target_cluster,
                        seed=args.seed, mesh=mesh, refine=args.refine,
                        model=args.model, bootstrap=args.bootstrap,
                        ml_steps=args.ml_steps, nni_rounds=args.nni_rounds,
                        starts=args.starts, spr_radius=args.spr_radius,
                        search_rounds=args.search_rounds,
                        ckpt_dir=ckpt_dir, resume=args.resume,
                        device=args.device)
    result = engine.build(msa)

    writer = mesh is None or mesh.rank == 0
    out = Path(args.out)
    with _trace.span("write", out=str(out)):
        if writer:
            out.mkdir(parents=True, exist_ok=True)
            (out / "tree.nwk").write_text(result.newick(names) + "\n")
    report = {"n_sequences": result.n_leaves, "width": msa.shape[1],
              "backend": result.backend, "requested_backend": args.backend,
              "tree_seconds": result.timings["total_seconds"],
              "tile_stats": result.tile_stats}
    if result.logl is not None:
        report["refine"] = args.refine
        report["model"] = result.model
        report["logl"] = result.logl
        report["bic"] = result.bic
        report["n_nni"] = result.n_nni
        report["refine_seconds"] = result.timings.get("refine_seconds")
        if result.search is not None:
            report["search"] = dict(result.search,
                                    starts=args.starts,
                                    spr_radius=args.spr_radius,
                                    ckpt_dir=ckpt_dir)
    if args.bootstrap > 0 and result.support is not None:
        finite = result.support[np.isfinite(result.support)]
        report["bootstrap"] = {
            "replicates": args.bootstrap, "seed": args.seed,
            "mean_support": round(float(finite.mean()), 4)
            if finite.size else None,
            "bootstrap_seconds": result.timings.get("bootstrap_seconds")}
    if args.tree_ll and args.alphabet != "protein":
        with _trace.span("loglik"):
            report["log_likelihood"] = float(likelihood.log_likelihood(
                msa, result.children, result.blen, result.root,
                gap_code=alpha.gap_code))
    if writer:
        (out / "report.json").write_text(json.dumps(report, indent=1))
        print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
