"""MSA/phylogeny web service launcher on PyTorch: the paper's web server.

  PYTHONPATH=src python -m repro_torch.launch.serve_msa --port 8642 \\
      [--method plain --backend auto] [--store-dir DIR] [--device cuda|cpu]
      [--dist --mesh 2x1]

Serves ``repro_torch.serve.MSAService`` over stdlib HTTP/JSON with the
flags, endpoints and status codes of ``repro.launch.serve_msa``:

  POST /align      {"fasta": ">a\\nACGT..."} or {"sequences": [...],
                   "names": [...]} -> aligned rows + msa_id; with
                   ?name=... (or "name" in the body) and --store-dir:
                   create/load a persistent named alignment
  POST /align/add  {"msa_id": ..., "fasta"/"sequences": ...} ->
                   incremental insertion against the frozen center;
                   {"name": ...} ingests into the store (one atomic
                   generation per add, background realign past drift)
  POST /tree       {"msa_id": ...}, {"name": ...} or sequences -> Newick
  POST /search     query sequences -> per-query top-k database hits
                   (needs --search-db / --search-index)
  GET  /healthz    liveness + cache / coalescing-queue stats
  GET  /metrics    Prometheus text exposition of the repro_torch.obs
                   registry
  GET  /statusz    human-readable status page (config, queues, spans)

``--device`` runs the service on the card (``cuda``, the default; it
raises when there is none) or on the plain PyTorch path (``cpu``).

``--dist [--mesh DxM]`` puts the service on a mesh of one process a rank
(``torchrun``, a process group the caller made, or a world of one, as for
``msa_run --dist``): families of ``--dist-threshold`` sequences or more
align through ``repro_torch.dist.mapreduce.msa_over_mesh``, and the tree
and search engines split their work over the mesh. Rank 0 serves HTTP
and owns the store; every other rank runs the service's job loop, which
rank 0 feeds by broadcast, and exits when rank 0 drains.

SIGINT/SIGTERM drain gracefully: the listener stops, in-flight requests
finish, the followers stop and the coalescing queue flushes before exit.
"""
from __future__ import annotations

import argparse
import os
import signal
import threading


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve_msa",
        description="MSA/phylogeny web service (PyTorch/CUDA port)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--alphabet", default="dna",
                    choices=["dna", "rna", "protein"])
    ap.add_argument("--method", default="plain",
                    choices=["plain", "sw", "kmer"],
                    help="map(1) path; kmer requests run uncoalesced")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "jnp", "pallas", "banded",
                             "banded-pallas"],
                    help="map(1) DP backend; auto/jnp/pallas run the full "
                         "DP, banded/banded-pallas the banded kernels, on "
                         "the device's route")
    ap.add_argument("--band", type=int, default=64,
                    help="band width for the banded backends")
    ap.add_argument("--k", type=int, default=11, help="k-mer width")
    ap.add_argument("--center", default="first",
                    choices=["first", "sampled"],
                    help="center selection policy")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="coalescing: flush at this many merged pairs")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="coalescing: max wait for request company")
    ap.add_argument("--cache-mb", type=int, default=256,
                    help="result cache byte budget (MiB)")
    ap.add_argument("--drift-threshold", type=float, default=0.25,
                    help="align/add relative width growth forcing a full "
                         "realign (for named alignments: the cumulative "
                         "growth that schedules a background realign)")
    ap.add_argument("--store-dir", default=None,
                    help="persistent MSA store root: enables named "
                         "alignments (/align?name=...) with atomic "
                         "generation commits surviving restarts")
    ap.add_argument("--store-keep", type=int, default=4,
                    help="generation files retained per named alignment")
    ap.add_argument("--store-realign", default="background",
                    choices=["background", "never"],
                    help="drift response for named alignments: realign on "
                         "a worker thread and swap atomically, or never")
    ap.add_argument("--tree-backend", default="auto",
                    choices=["auto", "dense", "tiled", "cluster"],
                    help="default /tree backend (repro_torch.phylo "
                         "registry)")
    ap.add_argument("--tree-refine", default="none",
                    choices=["none", "ml"],
                    help="default /tree refinement (requests can override "
                         "with {'refine': 'ml'})")
    ap.add_argument("--tree-model", default="auto",
                    choices=["auto", "jc69", "k80", "hky85", "gtr"],
                    help="substitution model for refine=ml (auto = BIC)")
    ap.add_argument("--tree-bootstrap", type=int, default=0,
                    help="default bootstrap replicates (requires "
                         "refine=ml; requests without it get a 400)")
    ap.add_argument("--tree-seed", type=int, default=0,
                    help="default bootstrap/ML seed (requests can "
                         "override with {'seed': N})")
    ap.add_argument("--cluster-threshold", type=int, default=64,
                    help="N at or below which cluster/auto trees go dense")
    ap.add_argument("--search-db", default=None,
                    help="database FASTA enabling POST /search")
    ap.add_argument("--search-index", default=None,
                    help="search-index artifact: loaded when present, "
                         "else built from --search-db and saved")
    ap.add_argument("--search-k", type=int, default=6,
                    help="seeding k-mer width for --search-db builds")
    ap.add_argument("--dist", action="store_true",
                    help="serve over a mesh (repro_torch.dist), one "
                         "process a rank; rank 0 serves HTTP")
    ap.add_argument("--mesh", default=None,
                    help="data x model for --dist, e.g. 4x1; default: "
                         "every rank x 1")
    ap.add_argument("--dist-threshold", type=int, default=512,
                    help="with --dist: sequence count at which a request "
                         "goes over the mesh")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) "
                         "or on the plain PyTorch path on the CPU")
    ap.add_argument("--verbose", action="store_true",
                    help="log one line per HTTP request")
    from ..obs import export as obs_export
    obs_export.add_output_args(ap)
    return ap


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.tree_bootstrap > 0 and args.tree_refine != "ml":
        parser.error("--tree-bootstrap requires --tree-refine ml "
                     "(otherwise every plain /tree request would 400)")
    if args.dist:
        # ML refinement on a mesh runs under deterministic algorithms;
        # cuBLAS reads its workspace configuration once, when it starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from ..device import resolve_device
    resolve_device(args.device)
    from .mesh import run_on_mesh
    with run_on_mesh(args.dist, args.mesh, args.device) as mesh:
        _serve(args, parser, mesh)


def _search_index(args, parser, writer: bool):
    """The /search database: loaded from --search-index when it exists,
    else built from --search-db (and saved there by the writing rank)."""
    if not (args.search_db or args.search_index):
        return None
    if args.alphabet == "protein":
        parser.error("--search-db needs a nucleotide --alphabet "
                     "(base-4 k-mer seeding)")
    from pathlib import Path

    from ..search import SearchIndex
    idx_path = Path(args.search_index) if args.search_index else None
    if idx_path is not None and idx_path.exists():
        return SearchIndex.load(idx_path)
    if not args.search_db:
        parser.error(f"--search-index {idx_path} does not exist; "
                     f"pass --search-db to build it")
    from ..data import read_fasta
    db_names, db_seqs = read_fasta(args.search_db)
    index = SearchIndex.build(db_names, db_seqs, k=args.search_k,
                              alphabet=args.alphabet, device=args.device)
    if idx_path is not None and writer:
        index.save(idx_path)
    return index


def _serve(args, parser, mesh):
    from ..serve import MSAService, ServiceConfig, serve_http
    rank0 = mesh is None or mesh.rank == 0
    search_index = _search_index(args, parser, rank0)
    service = MSAService(ServiceConfig(
        alphabet=args.alphabet, method=args.method, backend=args.backend,
        band=args.band, k=args.k, center=args.center,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        cache_bytes=args.cache_mb << 20,
        drift_threshold=args.drift_threshold,
        # only rank 0 owns (and writes) the store
        store_dir=args.store_dir if rank0 else None,
        store_keep=args.store_keep, store_realign=args.store_realign,
        tree_backend=args.tree_backend, tree_refine=args.tree_refine,
        tree_model=args.tree_model, tree_bootstrap=args.tree_bootstrap,
        tree_seed=args.tree_seed, cluster_threshold=args.cluster_threshold,
        mesh=mesh, dist_threshold=args.dist_threshold,
        search_index=search_index, device=args.device))
    if not rank0:
        if threading.current_thread() is threading.main_thread():
            # a terminal's Ctrl-C reaches every rank; rank 0 drains and
            # then stops this one
            signal.signal(signal.SIGINT, signal.SIG_IGN)
        try:
            n = service.follow()
        finally:
            service.drain()
        print(f"rank {mesh.rank}: ran {n} mesh job(s); rank 0 drained, "
              "bye", flush=True)
        return

    try:
        httpd = serve_http(service, args.host, args.port,
                           verbose=args.verbose)
    except BaseException:
        service.drain()
        raise

    def _shutdown(signum, frame):
        # runs on the main thread; shutdown() must come from another
        # thread, so just flip the flag serve_forever polls
        raise KeyboardInterrupt

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _shutdown)
    store_note = ""
    if service.store is not None:
        restored = service.store.names()
        store_note = (f" store={args.store_dir}"
                      f"[{len(restored)} named alignment(s)]")
    print(f"serving MSA/phylogeny on http://{args.host}:"
          f"{httpd.server_address[1]} (alphabet={args.alphabet} "
          f"method={args.method} backend={service.engine.route} "
          f"device={service.device}"
          f"{f' mesh={mesh.size} rank(s)' if mesh is not None else ''}"
          f"{f' search_db={search_index.n_seqs}' if search_index else ''}"
          f"{store_note}) — Ctrl-C drains", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        print("draining: finishing in-flight requests ...", flush=True)
        httpd.server_close()          # waits for handler threads
        service.drain()               # stop followers, flush the queue
    from ..obs import export as obs_export
    obs_export.write_outputs(args)
    print("drained; bye", flush=True)


if __name__ == "__main__":
    main()
