"""MSA launcher on PyTorch: FASTA in, aligned FASTA + tree out.

  PYTHONPATH=src python -m repro_torch.launch.msa_run --fasta in.fa \
      --out out/ [--method kmer] [--tree nj] [--device cuda|cpu]

The same flags and outputs as ``repro.launch.msa_run`` (``aligned.fasta``,
``tree.nwk``, ``report.json``), plus ``--device``: the run is on the card
(``cuda``, the default; it raises when there is none) or, with
``--device cpu``, on the plain PyTorch path. ``report["backend"]`` names
the DP route that ran (``cuda`` = the hand-written kernels, ``torch`` =
their plain versions). Flags of the reference whose path is not ported
yet raise an error naming the ROADMAP.md item: ``--dist``, ``--tree``
other than ``nj``/``none``, ``--backend banded*``, ``--tree-ll``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

_NOT_PORTED = {
    "dist": "--dist is not ported yet (ROADMAP.md §1 item 11, the "
            "distributed runtime)",
    "tree": "--tree {} is not ported yet (ROADMAP.md §1 item 8, tree "
            "backends; item 9 for ml)",
    "backend": "--backend {} is not ported yet (ROADMAP.md §1 item 7, "
               "banded alignment)",
    "tree_ll": "--tree-ll is not ported yet (ROADMAP.md §1 item 9, "
               "likelihood)",
}


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
                    help="tree backend (only nj and none are ported)")
    ap.add_argument("--cluster-threshold", type=int, default=64,
                    help="N at or below which cluster/auto tree backends "
                         "fall back to dense NJ")
    ap.add_argument("--tree-ll", action="store_true",
                    help="record the tree's JC69 log-likelihood (not "
                         "ported)")
    ap.add_argument("--k", type=int, default=11)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "jnp", "pallas", "banded",
                             "banded-pallas"],
                    help="map(1) DP backend; auto/jnp/pallas all run the "
                         "device's route (banded* not ported)")
    ap.add_argument("--band", type=int, default=64)
    ap.add_argument("--dist", action="store_true",
                    help="distributed pipeline (not ported)")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) "
                         "or on the plain PyTorch path on the CPU")
    from ..obs import export as obs_export
    obs_export.add_output_args(ap)
    return ap


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.dist:
        parser.error(_NOT_PORTED["dist"])
    if args.tree not in ("nj", "none"):
        parser.error(_NOT_PORTED["tree"].format(args.tree))
    if args.backend.startswith("banded"):
        parser.error(_NOT_PORTED["backend"].format(args.backend))
    if args.tree_ll:
        parser.error(_NOT_PORTED["tree_ll"])
    from ..device import resolve_device
    resolve_device(args.device)
    from ..obs import export as obs_export
    from ..obs import trace as _trace
    with _trace.request_trace(), _trace.span("msa_run", fasta=args.fasta):
        _run(args)
    obs_export.write_outputs(args)


def _run(args):
    from ..obs import trace as _trace
    with _trace.span("load"):
        import torch

        from ..align import resolve_backend
        from ..core import alphabet as ab
        from ..core import sp_score
        from ..core.msa import MSAConfig, center_star_msa, decode_msa
        from ..data import read_fasta, write_fasta
        names, seqs = read_fasta(args.fasta)

    dev = torch.device(args.device)
    alpha = {"dna": ab.DNA, "rna": ab.RNA, "protein": ab.PROTEIN}[args.alphabet]
    cfg = MSAConfig(method=args.method, alphabet=args.alphabet, k=args.k,
                    gap_open=11 if args.alphabet == "protein" else 3,
                    backend=args.backend, band=args.band)
    t0 = time.time()
    res = center_star_msa(seqs, cfg, device=dev)
    t_msa = time.time() - t0
    out = Path(args.out)
    with _trace.span("write", out=str(out)):
        out.mkdir(parents=True, exist_ok=True)
        write_fasta(out / "aligned.fasta", names, decode_msa(res.msa, cfg))

    with _trace.span("score"):
        msa = torch.as_tensor(res.msa, device=dev)
        sp = float(sp_score.avg_sp(msa, gap_code=alpha.gap_code,
                                   n_chars=alpha.n_chars))
    report = {"n_sequences": len(seqs), "width": res.width,
              "center": names[res.center_idx],
              "center_mode": res.center_mode,
              "backend": resolve_backend(args.backend, dev),
              "avg_sp_penalty": sp,
              "kmer_fallbacks": res.n_fallback,
              "msa_seconds": t_msa}

    if args.tree != "none":
        from ..phylo import TreeEngine
        t0 = time.time()
        engine = TreeEngine(gap_code=alpha.gap_code, n_chars=alpha.n_chars,
                            correct=args.alphabet != "protein",
                            backend="dense",
                            cluster_threshold=args.cluster_threshold,
                            device=args.device)
        tree_res = engine.build(res.msa)
        report["tree_seconds"] = time.time() - t0
        report["tree_backend"] = tree_res.backend
        nwk = tree_res.newick(names)
        with _trace.span("write", artifact="tree.nwk"):
            (out / "tree.nwk").write_text(nwk + "\n")

    with _trace.span("report"):
        (out / "report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
