"""Tree reconstruction from an already-aligned FASTA, on PyTorch.

  PYTHONPATH=src python -m repro_torch.launch.tree_run \
      --fasta aligned.fasta --out tree_out/ --backend tiled \
      [--row-block 128] [--tree-ll] [--device cuda|cpu]

The same flags and outputs as ``repro.launch.tree_run`` (``tree.nwk`` and
``report.json``: effective backend, tree seconds, for the tiled backends
the tile accountant's memory stats, and with ``--tree-ll`` the JC69
log-likelihood), plus ``--device``: the run is on the card (``cuda``, the
default; it raises when there is none) or, with ``--device cpu``, on the
plain PyTorch path. The distance counts go through the match/valid kernel
on the card.

Flags of the reference whose path is not ported yet exit with an error
naming the ROADMAP.md item when given: ``--refine ml|search``,
``--bootstrap`` > 0, ``--restartable``, ``--ckpt-dir``, ``--resume`` and
any value other than the default of the refinement settings ``--model``,
``--ml-steps``, ``--nni-rounds``, ``--starts``, ``--spr-radius`` and
``--search-rounds`` (item 9, likelihood and ML); ``--dist`` and
``--mesh`` (item 11, the distributed runtime).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

_ITEM9 = "ROADMAP.md §1 item 9, likelihood and ML"
_ITEM11 = "ROADMAP.md §1 item 11, the distributed runtime"
# settings read only by --refine ml|search: a value other than the
# default is refused rather than ignored
_REFINE_ONLY = ("model", "ml_steps", "nni_rounds", "starts", "spr_radius",
                "search_rounds")


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
    refine_only = f"for --refine; only the default is accepted ({_ITEM9})"
    ap.add_argument("--refine", default="none",
                    choices=["none", "ml", "search"],
                    help=f"only none is ported ({_ITEM9})")
    ap.add_argument("--model", default="auto",
                    choices=["auto", "jc69", "k80", "hky85", "gtr"],
                    help=f"substitution model {refine_only}")
    ap.add_argument("--bootstrap", type=int, default=0,
                    help=f"bootstrap replicates; only 0 is ported "
                         f"({_ITEM9})")
    ap.add_argument("--ml-steps", type=int, default=150, help=refine_only)
    ap.add_argument("--nni-rounds", type=int, default=8, help=refine_only)
    ap.add_argument("--starts", type=int, default=4, help=refine_only)
    ap.add_argument("--spr-radius", type=int, default=3, help=refine_only)
    ap.add_argument("--search-rounds", type=int, default=12,
                    help=refine_only)
    ap.add_argument("--restartable", action="store_true",
                    help=f"not ported ({_ITEM9})")
    ap.add_argument("--ckpt-dir", default=None,
                    help=f"not ported ({_ITEM9})")
    ap.add_argument("--resume", action="store_true",
                    help=f"not ported ({_ITEM9})")
    ap.add_argument("--dist", action="store_true",
                    help=f"not ported ({_ITEM11})")
    ap.add_argument("--mesh", default=None, help=f"not ported ({_ITEM11})")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) "
                         "or on the plain PyTorch path on the CPU")
    from ..obs import export as obs_export
    obs_export.add_output_args(ap)
    return ap


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.refine != "none":
        parser.error(f"--refine {args.refine} is not ported yet ({_ITEM9})")
    if args.bootstrap > 0:
        parser.error(f"--bootstrap is not ported yet ({_ITEM9})")
    for name in _REFINE_ONLY:
        if getattr(args, name) != parser.get_default(name):
            parser.error(f"--{name.replace('_', '-')} sets --refine ml|search, "
                         f"which is not ported yet ({_ITEM9})")
    if args.restartable or args.ckpt_dir or args.resume:
        parser.error("--restartable/--ckpt-dir/--resume are not ported yet "
                     f"({_ITEM9})")
    if args.dist or args.mesh is not None:
        parser.error(f"--dist/--mesh are not ported yet ({_ITEM11})")
    from ..device import resolve_device
    resolve_device(args.device)
    from ..obs import export as obs_export
    from ..obs import trace as _trace
    with _trace.request_trace(), _trace.span("tree_run", fasta=args.fasta):
        _run(args)
    obs_export.write_outputs(args)


def _run(args):
    from ..obs import trace as _trace
    with _trace.span("load"):
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

    engine = TreeEngine(gap_code=alpha.gap_code, n_chars=alpha.n_chars,
                        correct=args.alphabet != "protein",
                        backend=args.backend,
                        cluster_threshold=args.cluster_threshold,
                        row_block=args.row_block,
                        target_cluster=args.target_cluster,
                        seed=args.seed, device=args.device)
    result = engine.build(msa)

    out = Path(args.out)
    with _trace.span("write", out=str(out)):
        out.mkdir(parents=True, exist_ok=True)
        (out / "tree.nwk").write_text(result.newick(names) + "\n")
    report = {"n_sequences": result.n_leaves, "width": msa.shape[1],
              "backend": result.backend, "requested_backend": args.backend,
              "tree_seconds": result.timings["total_seconds"],
              "tile_stats": result.tile_stats}
    if args.tree_ll and args.alphabet != "protein":
        with _trace.span("loglik"):
            report["log_likelihood"] = float(likelihood.log_likelihood(
                msa, result.children, result.blen, result.root,
                gap_code=alpha.gap_code))
    (out / "report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
