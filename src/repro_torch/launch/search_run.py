"""Homology search launcher on PyTorch: query FASTA vs database FASTA ->
top-k hits, optionally chained to a tree per query family.

  PYTHONPATH=src python -m repro_torch.launch.search_run \\
      --db db.fasta --query q.fasta --out search_out/ \\
      [--index db.idx.npz] [--max-hits 10 --max-evalue 1e-3] \\
      [--score local|global --backend banded-pallas] [--pipeline] \\
      [--device cuda|cpu]

The same flags and outputs as ``repro.launch.search_run``
(``hits.json``, ``report.json``; with ``--pipeline`` each query family —
the query and its hits — is center-star aligned (``--method plain`` with
the chosen backend) and treed by dense NJ into
``family_<i>_<query>/aligned.fasta`` + ``tree.nwk``; with
``--bootstrap B > 0`` a family of at least 4 members gets an ML-refined
tree with B-replicate support labels instead), plus ``--device``: the run
is on the card (``cuda``, the default; it raises when there is none) or,
with ``--device cpu``, on the plain PyTorch path. An index saved by
either package loads in the other. ``--dist`` / ``--mesh DxM`` split the
seeding stage's DB tables over a mesh of ranks
(``repro_torch.dist.mapreduce.search_over_mesh``; the family trees'
bootstrap too), one process a rank as ``repro_torch.launch.msa_run
--dist`` runs; the hits are the same on every mesh shape, and rank 0
writes the files.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.search_run",
        description="query-vs-database homology search (PyTorch/CUDA "
                    "port); --pipeline chains search -> align -> tree per "
                    "query family")
    ap.add_argument("--db", default=None,
                    help="database FASTA (required unless --index exists)")
    ap.add_argument("--query", required=True, help="query FASTA")
    ap.add_argument("--index", default=None,
                    help="index artifact: loaded when present, else built "
                         "from --db and saved atomically")
    ap.add_argument("--out", default="search_out")
    ap.add_argument("--alphabet", default="dna", choices=["dna", "rna"])
    ap.add_argument("--seed-k", type=int, default=6,
                    help="seeding k-mer width (4^k * r int32 per DB seq)")
    ap.add_argument("--min-anchors", type=int, default=1,
                    help="chained anchors required to survive the "
                         "prefilter")
    ap.add_argument("--max-hits", type=int, default=10,
                    help="per-query top-k")
    ap.add_argument("--min-coverage", type=float, default=0.0,
                    help="aligned-column coverage of the query required")
    ap.add_argument("--max-evalue", type=float, default=10.0,
                    help="Karlin-Altschul e-value gate")
    ap.add_argument("--score", default="local",
                    choices=["local", "global"],
                    help="rescoring mode: local Smith-Waterman or global "
                         "Gotoh")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "jnp", "pallas", "banded",
                             "banded-pallas"],
                    help="rescoring DP backend: auto/jnp/pallas the full "
                         "DP, banded the banded forward kernel + "
                         "traceback, banded-pallas the fused banded kernel "
                         "(banded names take the full DP for --score "
                         "local)")
    ap.add_argument("--band", type=int, default=64,
                    help="band width for the banded backends")
    ap.add_argument("--exhaustive", action="store_true",
                    help="skip the seed prefilter and rescore every "
                         "(query, DB) pair — the recall oracle")
    ap.add_argument("--dist", action="store_true",
                    help="shard the seeding stage over the mesh "
                         "(repro_torch.dist.mapreduce.search_over_mesh)")
    ap.add_argument("--mesh", default=None,
                    help="data x model mesh, e.g. 2x1; with --dist alone: "
                         "every rank x 1")
    ap.add_argument("--pipeline", action="store_true",
                    help="center-star align + tree each query family "
                         "(query + its hits)")
    ap.add_argument("--bootstrap", type=int, default=0,
                    help="bootstrap replicates for family-tree support "
                         "labels (0 = plain NJ tree; >0 = ML-refined tree "
                         "with support)")
    ap.add_argument("--ml-steps", type=int, default=60,
                    help="adam steps per ML fit for --bootstrap trees")
    ap.add_argument("--seed", type=int, default=0,
                    help="bootstrap / ML seed")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) "
                         "or on the plain PyTorch path on the CPU")
    from ..obs import export as obs_export
    obs_export.add_output_args(ap)
    return ap


def _safe_name(name: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_"
                   for c in name)[:40] or "query"


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    from ..device import resolve_device
    resolve_device(args.device)
    from ..obs import export as obs_export
    from ..obs import trace as _trace
    from .mesh import run_on_mesh
    with run_on_mesh(args.dist or args.mesh is not None, args.mesh,
                     args.device) as mesh:
        with _trace.request_trace(), _trace.span("search_run",
                                                 query=args.query):
            _run(args, parser, mesh)
        if mesh is None or mesh.rank == 0:
            obs_export.write_outputs(args)


def _run(args, parser, mesh=None):
    from ..data import read_fasta, write_fasta
    from ..obs import trace as _trace
    from ..search import SearchConfig, SearchEngine, SearchIndex

    cfg = SearchConfig(alphabet=args.alphabet, k=args.seed_k,
                       min_anchors=args.min_anchors,
                       max_hits=args.max_hits,
                       min_coverage=args.min_coverage,
                       max_evalue=args.max_evalue,
                       local=args.score == "local",
                       backend=args.backend, band=args.band)
    engine = SearchEngine(cfg, mesh=mesh, device=args.device)
    writer = mesh is None or mesh.rank == 0

    t0 = time.time()
    with _trace.span("index"):
        index_path = Path(args.index) if args.index else None
        if index_path is not None and index_path.exists():
            index = SearchIndex.load(index_path)
            if index.k != args.seed_k or index.alphabet != args.alphabet:
                parser.error(
                    f"index {index_path} was built with k={index.k} "
                    f"alphabet={index.alphabet}; rebuild it (delete the "
                    f"file) or pass matching --seed-k/--alphabet")
            index_built = False
        else:
            if args.db is None:
                parser.error("--db is required when --index is absent or "
                             "does not exist yet")
            db_names, db_seqs = read_fasta(args.db)
            index = engine.build_index(db_names, db_seqs)
            if index_path is not None and writer:
                index.save(index_path)
            index_built = True
    t_index = time.time() - t0

    q_names, q_seqs = read_fasta(args.query)
    t0 = time.time()
    with _trace.span("search", n_queries=len(q_seqs)):
        result = engine.search(q_names, q_seqs, index,
                               exhaustive=args.exhaustive)
    t_search = time.time() - t0

    out = Path(args.out)
    if writer:
        out.mkdir(parents=True, exist_ok=True)
        (out / "hits.json").write_text(json.dumps(result, indent=1))

    report = {
        "n_queries": len(q_seqs),
        "db_seqs": index.n_seqs, "db_residues": index.db_residues,
        "seed_k": index.k, "index_built": index_built,
        "stats": result["stats"],
        "index_seconds": t_index, "search_seconds": t_search,
        "queries_per_second": (len(q_seqs) / t_search
                               if t_search > 0 else None)}

    if args.pipeline:
        with _trace.span("pipeline", n_queries=len(q_seqs)):
            report["families"] = _run_pipeline(args, out, index, result,
                                               q_seqs, mesh, write_fasta)

    if writer:
        (out / "report.json").write_text(json.dumps(report, indent=1))
        print(json.dumps(report, indent=1))


def _run_pipeline(args, out: Path, index, result, q_seqs, mesh,
                  write_fasta):
    """search -> align -> tree: one family (query + hits) per query."""
    import numpy as np

    from ..core import alphabet as ab
    from ..core.msa import MSAConfig, center_star_msa, decode_msa
    from ..phylo import TreeEngine

    alpha = {"dna": ab.DNA, "rna": ab.RNA}[args.alphabet]
    msa_cfg = MSAConfig(method="plain", alphabet=args.alphabet,
                        backend=args.backend, band=args.band)
    writer = mesh is None or mesh.rank == 0
    families = []
    for i, q in enumerate(result["queries"]):
        fam_dir = out / f"family_{i:03d}_{_safe_name(q['name'])}"
        names = [q["name"]] + [h["target"] for h in q["hits"]]
        seqs = [q_seqs[i]] + [_db_seq(index, h["db_idx"], alpha)
                              for h in q["hits"]]
        info = {"query": q["name"], "n_members": len(seqs),
                "dir": fam_dir.name}
        if len(seqs) < 3:
            info["skipped"] = "family needs >= 3 members for a tree"
            families.append(info)
            continue
        res = center_star_msa(seqs, msa_cfg, device=args.device)
        if writer:
            fam_dir.mkdir(parents=True, exist_ok=True)
            write_fasta(fam_dir / "aligned.fasta", names,
                        decode_msa(res.msa, msa_cfg))
        refine = "ml" if args.bootstrap > 0 and len(seqs) >= 4 else "none"
        engine = TreeEngine(gap_code=alpha.gap_code, n_chars=alpha.n_chars,
                            backend="dense", mesh=mesh, refine=refine,
                            bootstrap=args.bootstrap if refine == "ml" else 0,
                            ml_steps=args.ml_steps, seed=args.seed,
                            device=args.device)
        tree = engine.build(res.msa)
        if writer:
            (fam_dir / "tree.nwk").write_text(tree.newick(names) + "\n")
        info.update(width=res.width, tree_backend=tree.backend,
                    refine=refine)
        if tree.support is not None:
            finite = tree.support[np.isfinite(tree.support)]
            info["mean_support"] = (round(float(finite.mean()), 4)
                                    if finite.size else None)
        families.append(info)
    return families


def _db_seq(index, db_idx: int, alpha) -> str:
    row = index.S[db_idx][: int(index.lens[db_idx])]
    return alpha.decode(row)


if __name__ == "__main__":
    main()
