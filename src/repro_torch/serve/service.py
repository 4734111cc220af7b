"""MSAService: the web-service facade over align / phylo / dist / serve.

The request dataflow:

  POST /align      FASTA/JSON -> canonicalize -> cache lookup -> on miss,
                   center-select and submit the map(1) work to the
                   coalescing queue (one ``align_pairs`` batch serves
                   many concurrent requests) -> center-star assembly ->
                   cache fill -> rows mapped back to the caller's order.
                   With ``?name=`` (or ``"name"`` in the body) and a
                   configured ``--store-dir``: creates (sequences given)
                   or loads (no sequences) a *persistent named
                   alignment* in the ``store.MSAStore``
  POST /align/add  incremental insertion into a cached MSA against its
                   frozen center (``incremental.add_to_msa``); with
                   ``"name"`` the insertion commits a new store
                   generation (atomic, crash-safe) and past the drift
                   threshold schedules a *background* realign — readers
                   keep the stale-but-valid generation until the
                   realigned one swaps in
  POST /tree       TreeEngine over a cached MSA (tree results memoized
                   through the engine's cache hook) or fresh sequences;
                   ``"refine": "ml"`` routes through the ML refiner —
                   the cache fingerprint spans backend, refine mode,
                   substitution model, bootstrap count, and seed
  POST /search     query sequences -> per-query top-k database hits
                   (``repro_torch.search``: mesh-shardable seed prefilter +
                   DP rescore + e-value gates), content-hash cached
                   like ``/align`` — requires a configured
                   ``ServiceConfig.search_index``
  GET  /healthz    liveness + cache / queue stats (one atomic snapshot)
  GET  /metrics    Prometheus text exposition of the ``repro_torch.obs``
                   registry
  GET  /statusz    human-readable service snapshot (plain text)

Every request runs under ``repro_torch.obs``: a fresh trace ID is opened per
request (returned as ``trace_id`` in each JSON response, stamped on every
span the request produces), request counters reconcile as
``started == finished + rejected``, and latency histograms cover the
request and the coalescer's queue wait / batch occupancy.

Everything runs on ``ServiceConfig.device`` — the card by default (it
raises when there is none), the plain PyTorch path with ``"cpu"``: the
align engine, the coalescer's batches, the tree and search engines and
the store. A handler thread makes that card its current device for the
request (the kernels launch on the current stream of their card).
``/healthz``'s ``backend`` names the DP route that runs (``cuda`` /
``torch``, ``-banded`` for the banded backends), as ``msa_run``'s report
does.

Big requests compose with ``repro_torch.dist``: with a mesh configured,
families of ``dist_threshold`` or more sequences route through
``mapreduce.msa_over_mesh`` instead of the coalescing queue, and the
tree and search engines split their work over the same mesh. The mesh is
SPMD — one process a rank, and every collective needs every rank — so
rank 0 serves and the other ranks run ``MSAService.follow``: each call
that touches the mesh goes through ``MeshJobs.run`` on rank 0, which
broadcasts the job to the followers and runs it; the followers run the
same call and drop its result. Only rank 0 owns a store.

``serve_http`` wraps the facade in a stdlib ThreadingHTTPServer;
``drain()`` refuses new work, lets in-flight requests finish, and
flushes the queue — the graceful-shutdown path ``launch/serve_msa``
wires to SIGINT/SIGTERM.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import msa as msa_mod
from ..core.msa import MSAConfig
from ..data import iter_fasta
from ..data.fasta import _normalize_seq
from ..device import on_device, resolve_device
from ..dist import sharding as _sh
from ..obs import metrics as _obs
from ..obs import trace as _trace
from ..phylo import TreeEngine
from . import incremental
from .cache import ResultCache, canonical_key, canonicalize
from .queue import AlignJob, CoalescingAligner
from .store import MSAStore
from .store import StoreError as _StoreError

_M_STARTED = _obs.counter("repro_requests_started_total",
                          "requests received (accepted + rejected)",
                          ("endpoint",))
_M_FINISHED = _obs.counter("repro_requests_finished_total",
                           "requests completed", ("endpoint", "status"))
_M_REJECTED = _obs.counter("repro_requests_rejected_total",
                           "requests refused while draining", ("endpoint",))
_H_LATENCY = _obs.histogram("repro_request_seconds",
                            "request wall-clock", ("endpoint",))
_G_ACTIVE = _obs.gauge("repro_requests_active", "requests currently in flight")
_C_MESH_JOBS = _obs.counter("repro_mesh_jobs_total",
                            "jobs rank 0 broadcast to the mesh", ("kind",))

# a follower waits in a broadcast for rank 0's next job; rank 0 sends a
# no-op job once the mesh has been idle this long, well inside the process
# group's timeout (``launch.mesh.TIMEOUT``)
HEARTBEAT_S = 30.0


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Server-wide alignment/tree configuration (fixed per process —
    request payloads carry data, not scoring knobs, so one engine serves
    all traffic). ``mesh`` is a ``dist.sharding.Mesh`` over the world's
    ranks; ``fingerprint`` is the reference's string, so ``msa_id`` and
    the tree and search keys are the reference's too."""
    alphabet: str = "dna"
    method: str = "plain"        # plain | sw | kmer (kmer runs uncoalesced)
    backend: str = "auto"        # align backend registry
    band: int = 64
    k: int = 11
    center: str = "first"
    max_batch: int = 256         # coalescing: flush at this many pairs
    max_wait_ms: float = 5.0     # coalescing: max time a request waits
    cache_bytes: int = 256 << 20
    cache_items: int = 4096
    tree_cache_items: int = 256
    drift_threshold: float = 0.25
    tree_backend: str = "auto"
    tree_refine: str = "none"    # none | ml: /tree default refinement
    tree_model: str = "auto"     # substitution model for refine=ml
    tree_bootstrap: int = 0      # bootstrap replicates for refine=ml
    tree_seed: int = 0           # bootstrap / ML seed
    cluster_threshold: int = 64
    mesh: Optional[object] = None
    dist_threshold: int = 512    # with a mesh: route N >= this through
                                 # mapreduce.msa_over_mesh
    search_index: Optional[object] = None   # search.SearchIndex:
                                            # enables POST /search
    search_cfg: Optional[object] = None     # SearchConfig override
                                            # (default: index-matched)
    store_dir: Optional[str] = None         # persistent MSAStore root:
                                            # enables named alignments
    store_keep: int = 4                     # generations retained / name
    store_realign: str = "background"       # background | never
    device: str = "cuda"                    # cuda (raises without a
                                            # card) | cpu

    def __post_init__(self):
        resolve_device(self.device)

    def msa_cfg(self) -> MSAConfig:
        return MSAConfig(method=self.method, alphabet=self.alphabet,
                         k=self.k, center=self.center,
                         gap_open=11 if self.alphabet == "protein" else 3,
                         backend=self.backend, band=self.band)

    def fingerprint(self) -> str:
        c = self.msa_cfg()
        return (f"{c.alphabet}/{c.method}/{c.backend}/{c.band}/{c.k}/"
                f"{c.center}/{c.gap_open}/{c.gap_extend}")


def parse_sequences(payload: dict) -> Tuple[List[str], List[str]]:
    """Extract (names, sequences) from a request body.

    Accepts ``{"fasta": "..."} `` (streamed through ``iter_fasta`` — the
    text is parsed record-by-record, never re-joined) or
    ``{"sequences": [...], "names": [...]}``. Both paths apply the same
    normalization (uppercase, ``.``→``-``, ``\\r`` stripped, invalid
    characters rejected) so identical data yields identical alignments
    and cache keys regardless of payload format.
    """
    if "fasta" in payload:
        names, seqs = [], []
        for name, seq in iter_fasta(io.StringIO(payload["fasta"])):
            names.append(name)
            seqs.append(seq)
    elif "sequences" in payload:
        raw = payload["sequences"]
        names = payload.get("names") or [f"seq{i}" for i in range(len(raw))]
        if len(names) != len(raw):
            raise ValueError(f"{len(names)} names for {len(raw)} sequences")
        seqs = [_normalize_seq([s.replace("\r", "")], n)
                for n, s in zip(names, raw)]
    else:
        raise ValueError("request needs 'fasta' or 'sequences'")
    if not seqs:
        raise ValueError("no sequences in request")
    return names, seqs


class MeshJobs:
    """The service's collectives over an SPMD mesh, in one order.

    Rank 0 calls ``run(kind, *args)``: under one lock it broadcasts
    ``(kind, args)`` to the other ranks and then runs ``handlers[kind]``
    itself, so broadcast order is execution order and two handler
    threads never interleave two collectives. The other ranks sit in
    ``follow``, which receives each job and runs the same handler on the
    same arguments (its result is dropped). ``stop`` on rank 0 ends the
    followers' loop. While idle, rank 0 sends a no-op job every
    ``HEARTBEAT_S`` so that a follower's wait never reaches the process
    group's timeout.

    A job that raises ``ValueError`` failed on the data: every rank runs
    the same call on the same data and meets it at the same point, so
    the mesh goes on (rank 0 reports it, a follower drops it). Any other
    error is a fault of the rank that raised it (a failed launch, an
    out-of-memory, a lost peer), and the other ranks may be waiting in
    one of the job's collectives: that rank leaves the process group at
    once, which makes their pending collectives raise instead of waiting
    out its timeout, and the mesh is stopped for good. Rank 0 then
    answers the request, and every later mesh job, with a
    ``RuntimeError`` (503); a follower's ``follow`` re-raises the error.
    """

    def __init__(self, mesh, handlers: Dict[str, Callable]):
        self.mesh = mesh
        self.handlers = handlers
        self.lock = threading.Lock()
        self._stopped = False
        self.broken = None              # the fault that stopped the mesh
        self.n_jobs = 0                 # jobs run (not the no-op ones)
        self._last = time.monotonic()
        self._wake = threading.Event()
        self._beat = None
        if mesh.rank == 0 and mesh.size > 1:
            self._beat = threading.Thread(
                target=self._heartbeat, args=(float(HEARTBEAT_S),),
                name="mesh-heartbeat", daemon=True)
            self._beat.start()

    def _send(self, job) -> None:
        """Broadcast ``job`` from rank 0; caller holds ``self.lock``."""
        with on_device(self.mesh.device):
            _sh.broadcast_object(job, self.mesh)
        self._last = time.monotonic()

    def _break(self, err: BaseException) -> None:
        """Stop the mesh for good after a fault on this rank, leaving the
        process group so that the other ranks' collectives with this one
        fail at once; caller holds ``self.lock`` (or follows)."""
        self._stopped = True
        self.broken = repr(err)
        if dist.is_initialized():
            dist.destroy_process_group(self.mesh.group)

    def run(self, kind: str, *args):
        """Rank 0: broadcast the job, then run it here (the caller is on
        the mesh's device); returns its result."""
        with self.lock:
            if self._stopped:
                raise RuntimeError(
                    "service is draining (mesh stopped)" if self.broken is
                    None else f"mesh stopped by a fault: {self.broken}")
            _C_MESH_JOBS.labels(kind=kind).inc()
            self.n_jobs += 1
            try:
                self._send((kind, args))
                return self.handlers[kind](*args)
            except ValueError:
                raise
            except Exception as e:        # noqa: BLE001
                self._break(e)
                raise RuntimeError(f"mesh job {kind!r} failed ({e!r}); "
                                   "the mesh is stopped") from e

    def _heartbeat(self, every: float) -> None:
        while not self._wake.wait(every / 4):
            with self.lock:
                if self._stopped:
                    return
                if time.monotonic() - self._last >= every:
                    try:
                        self._send(("ping", ()))
                    except Exception as e:    # noqa: BLE001
                        self._break(e)
                        return

    def stop(self) -> None:
        """Rank 0: send the followers the stop job (idempotent)."""
        with self.lock:
            if not self._stopped:
                self._stopped = True
                if self.mesh.rank == 0:
                    try:
                        self._send(("stop", ()))
                    except Exception as e:    # noqa: BLE001
                        self._break(e)        # a follower is gone
        self._wake.set()
        if self._beat is not None:
            self._beat.join()

    def follow(self) -> int:
        """A follower's loop: run rank 0's jobs until its stop job;
        returns the number of jobs run."""
        if self.mesh.rank == 0:
            raise RuntimeError("rank 0 serves; only the other ranks follow")
        with on_device(self.mesh.device):
            while True:
                kind, args = _sh.broadcast_object(None, self.mesh)
                if kind == "stop":
                    self._stopped = True
                    return self.n_jobs
                if kind == "ping":
                    continue
                self.n_jobs += 1
                try:
                    self.handlers[kind](*args)
                except ValueError:
                    pass                  # the data's; rank 0 reports it
                except Exception as e:    # noqa: BLE001
                    self._break(e)
                    raise


class MSAService:
    """The service facade; thread-safe — HTTP handler threads call in."""

    def __init__(self, cfg: Optional[ServiceConfig] = None):
        cfg = ServiceConfig() if cfg is None else cfg
        if (cfg.store_dir is not None and cfg.mesh is not None
                and cfg.mesh.rank != 0):
            raise ValueError("only rank 0 of a mesh owns the store "
                             "(store_dir=None on the other ranks)")
        self.cfg = cfg
        self.device = self._resolve_device(cfg)
        self.msa_cfg = cfg.msa_cfg()
        self.alpha = self.msa_cfg.alpha()
        self.engine = self.msa_cfg.engine(self.device)
        self.cache = ResultCache(max_bytes=cfg.cache_bytes,
                                 max_items=cfg.cache_items)
        self.coalescer = CoalescingAligner(max_batch=cfg.max_batch,
                                           max_wait_ms=cfg.max_wait_ms)
        self.tree_cache: OrderedDict = OrderedDict()
        self._tree_lock = threading.Lock()
        self._draining = False
        self._active = 0
        self._active_cond = threading.Condition()
        self._t0 = time.time()
        self.store = None
        self._mesh = None
        if cfg.mesh is not None:
            self._mesh = MeshJobs(cfg.mesh, {"msa": self._mesh_msa,
                                             "tree": self._mesh_tree,
                                             "search": self._mesh_search})
        if cfg.store_dir is not None:
            self.store = MSAStore(cfg.store_dir, keep=cfg.store_keep,
                                  drift_threshold=cfg.drift_threshold,
                                  realign=cfg.store_realign,
                                  device=self.device)
        self.search_engine = None
        self._search_db_fp = None
        if cfg.search_index is not None:
            from ..search import SearchConfig, SearchEngine
            scfg = cfg.search_cfg or SearchConfig(
                alphabet=cfg.search_index.alphabet, k=cfg.search_index.k)
            self.search_engine = SearchEngine(scfg, mesh=cfg.mesh,
                                              device=str(self.device))
            # the database half of every /search cache key; hash it once
            self._search_db_fp = cfg.search_index.fingerprint()

    @staticmethod
    def _resolve_device(cfg: ServiceConfig) -> torch.device:
        """The service's device: the mesh's rank device with a mesh, else
        ``cfg.device`` (a card pinned to its index)."""
        dev = resolve_device(cfg.device)
        if cfg.mesh is not None:
            if cfg.mesh.device.type != dev.type:
                raise ValueError(f"mesh on {cfg.mesh.device}, service "
                                 f"device {cfg.device!r}")
            return cfg.mesh.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    # -------------------------------------------------------- mesh jobs
    # each runs on every rank of the mesh, rank 0's through MeshJobs.run

    def _mesh_msa(self, canon: List[str]):
        from ..dist import mapreduce
        return mapreduce.msa_over_mesh(canon, self.msa_cfg, self.cfg.mesh)

    def _mesh_tree(self, msa: np.ndarray, kw: dict):
        return TreeEngine(**kw, mesh=self.cfg.mesh,
                          device=str(self.device)).build(msa)

    def _mesh_search(self, canon: List[str], max_hits: int,
                     min_coverage: float, max_evalue: float) -> dict:
        return self.search_engine.search(
            [f"q{i}" for i in range(len(canon))], canon,
            self.cfg.search_index, max_hits=max_hits,
            min_coverage=min_coverage, max_evalue=max_evalue)

    def follow(self) -> int:
        """A follower rank's loop (ranks other than 0 of a mesh): run
        rank 0's mesh jobs until it drains; returns the jobs run."""
        if self._mesh is None:
            raise RuntimeError("follow() needs a service over a mesh")
        return self._mesh.follow()

    # ----------------------------------------------------------- helpers

    @contextlib.contextmanager
    def _request(self, endpoint: str) -> Iterator[str]:
        """Per-request accounting + trace scope.

        Counts reconcile as ``started == finished + rejected`` whenever the
        service is idle; ``drain()`` waits on the active count this context
        maintains, so a request inside this block can never be cut off by
        shutdown.  Yields the request's trace ID (every span opened inside
        inherits it; the HTTP layer returns it to the client).
        """
        _M_STARTED.labels(endpoint=endpoint).inc()
        with self._active_cond:
            if self._draining:
                _M_REJECTED.labels(endpoint=endpoint).inc()
                raise RuntimeError("service is draining")
            self._active += 1
            _G_ACTIVE.set(self._active)
        t0 = time.perf_counter()
        status = "ok"
        try:
            with _trace.request_trace() as tid, on_device(self.device):
                with _trace.span(f"serve.{endpoint}"):
                    yield tid
        except BaseException:
            status = "error"
            raise
        finally:
            _H_LATENCY.labels(endpoint=endpoint).observe(
                time.perf_counter() - t0)
            _M_FINISHED.labels(endpoint=endpoint, status=status).inc()
            with self._active_cond:
                self._active -= 1
                _G_ACTIVE.set(self._active)
                self._active_cond.notify_all()

    def _compute_canonical(self, canon: List[str], names: List[str]) -> dict:
        """Align the canonical-order family; returns the cache entry."""
        gap = self.alpha.gap_code
        cfg = self.msa_cfg
        mesh = self.cfg.mesh
        meta = None
        if mesh is not None and len(canon) >= self.cfg.dist_threshold:
            res = self._mesh.run("msa", canon)
            msa, cidx, width = res.msa, res.center_idx, res.width
            path = "dist"
        elif cfg.method == "kmer" or len(canon) < 2:
            # the k-mer path needs a per-center index; it runs standalone
            res = msa_mod.center_star_msa(canon, cfg, device=self.device)
            msa, cidx, width = res.msa, res.center_idx, res.width
            path = "standalone"
        else:
            dev = self.device
            S, lens = msa_mod.encode_for_msa(canon, cfg)
            S = torch.as_tensor(S, device=dev)
            lens = torch.as_tensor(lens, device=dev).to(torch.int32)
            cidx, _ = msa_mod._select_center(S, lens, cfg)
            lc = int(lens[cidx])
            others = np.array([i for i in range(len(canon)) if i != cidx])
            oix = torch.as_tensor(others, device=dev)
            center = S[cidx][:lc]
            job = AlignJob(Q=S[oix], qlens=lens[oix], target=center,
                           tlen=lc, engine=self.engine,
                           engine_key=self.cfg.fingerprint())
            jr = self.coalescer.submit(job).result()
            msa, width = msa_mod.assemble_center_star(
                torch.as_tensor(jr.a_row, device=dev),
                torch.as_tensor(jr.b_row, device=dev), center, lc,
                others=others, cidx=int(cidx), n_total=len(canon), gap=gap)
            meta = jr.meta
            path = "coalesced"
        return {"msa": np.asarray(msa), "center_idx": int(cidx),
                "width": int(width), "seqs": canon, "names": names,
                "path": path, "coalesce": meta}

    def _entry_bytes(self, entry: dict) -> int:
        return entry["msa"].nbytes + sum(len(s) for s in entry["seqs"])

    def _alignment_payload(self, msa_id: str, entry: dict,
                           names: Optional[List[str]] = None,
                           row_order: Optional[List[int]] = None) -> dict:
        rows = msa_mod.decode_msa(entry["msa"], self.msa_cfg)
        if row_order is not None:
            rows = [rows[i] for i in row_order]
        return {"msa_id": msa_id,
                "names": names if names is not None else entry["names"],
                "rows": rows, "width": entry["width"],
                "center_idx": (row_order.index(entry["center_idx"])
                               if row_order is not None
                               else entry["center_idx"])}

    # ----------------------------------------------------------- methods

    def _align_entry(self, names: List[str], seqs: List[str]
                     ) -> Tuple[str, dict, bool, List[int]]:
        """Shared align resolution: (key, entry, cached, perm).

        Returns the entry object directly — consumers must not re-resolve
        the key through the cache (an entry bigger than the byte budget,
        or concurrent LRU pressure, can evict it between put and peek).
        """
        canon, perm = canonicalize(seqs)
        # canon is already sorted, so the key's internal re-sort is O(n)
        key = canonical_key(canon, self.cfg.fingerprint())
        entry = self.cache.get(key)
        cached = entry is not None
        if not cached:
            entry = self._compute_canonical(canon,
                                            [names[i] for i in perm])
            self.cache.put(key, entry, self._entry_bytes(entry))
        return key, entry, cached, perm

    def align(self, names: Sequence[str], seqs: Sequence[str]) -> dict:
        with self._request("align") as tid:
            return dict(self._align_impl(names, seqs), trace_id=tid)

    # ------------------------------------------------- named (store-backed)

    def _store_required(self):
        if self.store is None:
            raise ValueError("no persistent store configured "
                             "(serve_msa --store-dir)")
        return self.store

    def _store_payload(self, entry) -> dict:
        """Response body for a committed store generation."""
        return {"name": entry.name, "generation": entry.generation,
                "fingerprint": entry.fingerprint,
                "names": list(entry.names),
                "rows": msa_mod.decode_msa(entry.msa, self.msa_cfg),
                "width": entry.width, "center_idx": entry.center_idx}

    def align_named(self, name: str, names: Optional[Sequence[str]] = None,
                    seqs: Optional[Sequence[str]] = None) -> dict:
        """``POST /align?name=``: create (sequences given) or load (no
        sequences) a persistent named alignment."""
        with self._request("align") as tid:
            return dict(self._align_named_impl(name, names, seqs),
                        trace_id=tid)

    def _align_named_impl(self, name, names, seqs) -> dict:
        t0 = time.perf_counter()
        store = self._store_required()
        if seqs:
            seqs = list(seqs)
            names = list(names) if names else [f"seq{i}"
                                               for i in range(len(seqs))]
            # align through the shared cached/coalesced path; the store
            # persists the canonical order (what the cache entry holds)
            _, entry, cached, _ = self._align_entry(names, seqs)
            se = store.create(name, msa=entry["msa"],
                              center_idx=entry["center_idx"],
                              seqs=entry["seqs"], names=entry["names"])
            created = True
        else:
            se = store.get(name)                 # KeyError -> 404
            created, cached = False, True
        return {"alignment": self._store_payload(se), "created": created,
                "cached": cached, "store": store.stats(),
                "elapsed_ms": (time.perf_counter() - t0) * 1e3}

    def _align_impl(self, names: Sequence[str], seqs: Sequence[str]) -> dict:
        t0 = time.perf_counter()
        names, seqs = list(names), list(seqs)
        key, entry, cached, perm = self._align_entry(names, seqs)
        # map canonical rows back to this request's order: canonical row i
        # holds request sequence perm[i], so request row j is canonical
        # row inv[j]
        inv = [0] * len(perm)
        for i, p in enumerate(perm):
            inv[p] = i
        return {"alignment": self._alignment_payload(key, entry,
                                                     names=names,
                                                     row_order=inv),
                "cached": cached, "path": entry["path"],
                "coalesce": entry["coalesce"],
                "cache": self.cache.stats(),
                "elapsed_ms": (time.perf_counter() - t0) * 1e3}

    def align_add(self, msa_id: Optional[str] = None,
                  names: Sequence[str] = (), seqs: Sequence[str] = (), *,
                  name: Optional[str] = None) -> dict:
        with self._request("align_add") as tid:
            if name is not None:
                return dict(self._align_add_named_impl(name, names, seqs),
                            trace_id=tid)
            return dict(self._align_add_impl(msa_id, names, seqs),
                        trace_id=tid)

    def _align_add_named_impl(self, name, names, seqs) -> dict:
        """Continuous ingestion: one committed store generation per add."""
        t0 = time.perf_counter()
        store = self._store_required()
        entry, info = store.add(name, list(names), list(seqs),
                                self.msa_cfg, engine=self.engine)
        return {"alignment": self._store_payload(entry), "add": info,
                "store": store.stats(),
                "elapsed_ms": (time.perf_counter() - t0) * 1e3}

    def _align_add_impl(self, msa_id: str, names: Sequence[str],
                        seqs: Sequence[str]) -> dict:
        t0 = time.perf_counter()
        parent = self.cache.peek(msa_id)
        if parent is None:
            raise KeyError(f"unknown msa_id {msa_id!r}")
        names, seqs = list(names), list(seqs)
        center_seq = parent["seqs"][parent["center_idx"]] \
            if parent["center_idx"] < len(parent["seqs"]) else ""
        key = canonical_key(parent["seqs"] + seqs, self.cfg.fingerprint(),
                            center=center_seq)
        entry = self.cache.get(key)
        cached = entry is not None
        add_info = entry["add"] if cached else None
        if not cached:
            res = incremental.add_to_msa(
                parent["msa"], parent["center_idx"], seqs, self.msa_cfg,
                drift_threshold=self.cfg.drift_threshold,
                engine=self.engine)
            add_info = {"n_new": res.n_new, "realigned": res.realigned,
                        "growth": round(res.growth, 4)}
            entry = {"msa": res.msa, "center_idx": res.center_idx,
                     "width": res.width,
                     "seqs": parent["seqs"] + seqs,
                     "names": parent["names"] + names,
                     "path": "incremental", "coalesce": None,
                     "add": add_info}
            self.cache.put(key, entry, self._entry_bytes(entry))
        # on a hit, credit the caller's names for the added rows when the
        # request's new-sequence order matches the stored suffix (a
        # different order still hits the same canonical key; rows then
        # keep the first filler's order and names)
        resp_names = None
        if cached and entry["seqs"][len(entry["seqs"]) - len(seqs):] == seqs:
            resp_names = entry["names"][: len(entry["names"]) - len(names)] \
                + names
        return {"alignment": self._alignment_payload(key, entry,
                                                     names=resp_names),
                "cached": cached, "path": entry["path"], "add": add_info,
                "cache": self.cache.stats(),
                "elapsed_ms": (time.perf_counter() - t0) * 1e3}

    def tree(self, msa_id: Optional[str] = None, **kw) -> dict:
        with self._request("tree") as tid:
            return dict(self._tree_impl(msa_id=msa_id, **kw), trace_id=tid)

    def _tree_impl(self, msa_id: Optional[str] = None,
                   name: Optional[str] = None,
                   names: Optional[Sequence[str]] = None,
                   seqs: Optional[Sequence[str]] = None,
                   backend: Optional[str] = None,
                   refine: Optional[str] = None,
                   model: Optional[str] = None,
                   bootstrap: Optional[int] = None,
                   seed: Optional[int] = None) -> dict:
        t0 = time.perf_counter()
        store_entry = None
        if name is not None:
            # named alignments key the tree cache by the generation's
            # content fingerprint — a tree can never mix generations,
            # and an add or realign swap naturally invalidates it
            store_entry = self._store_required().get(name)
            entry = {"msa": store_entry.msa,
                     "names": list(store_entry.names)}
            msa_id = f"store:{name}@{store_entry.fingerprint}"
        elif msa_id is None:
            if not seqs:
                raise ValueError(
                    "tree request needs 'msa_id', 'name', or sequences")
            seqs = list(seqs)
            msa_id, entry, _, _ = self._align_entry(
                list(names) if names else [f"seq{i}"
                                           for i in range(len(seqs))], seqs)
        else:
            entry = self.cache.peek(msa_id)
            if entry is None:
                raise KeyError(f"unknown msa_id {msa_id!r}")
        be = backend or self.cfg.tree_backend
        refine = refine or self.cfg.tree_refine
        model = model or self.cfg.tree_model
        if bootstrap is None:
            # the server-wide bootstrap default only makes sense under ML
            # refinement; a request overriding refine to "none" must not
            # inherit it (it would 400 on bootstrap-requires-ml)
            bootstrap = self.cfg.tree_bootstrap if refine == "ml" else 0
        bootstrap = int(bootstrap)
        seed = int(self.cfg.tree_seed if seed is None else seed)
        kw = dict(gap_code=self.alpha.gap_code,
                  n_chars=self.alpha.n_chars,
                  correct=self.cfg.alphabet != "protein",
                  backend=be,
                  cluster_threshold=self.cfg.cluster_threshold,
                  refine=refine, model=model,
                  bootstrap=bootstrap, seed=seed)
        engine = TreeEngine(**kw, mesh=self.cfg.mesh,
                            device=str(self.device))
        # the tree fingerprint spans everything that changes the result:
        # backend, refinement mode, substitution model, replicate count,
        # and the seed. An unrefined tree ignores model/bootstrap (those
        # collapse out of the key — no cache fragmentation for identical
        # results) but keeps seed: cluster/tiled sketch sampling uses it
        tkey = f"{msa_id}/{be}/none/{seed}" if refine == "none" else \
            f"{msa_id}/{be}/{refine}/{model}/{bootstrap}/{seed}"
        # tree_cache is shared across handler threads: the lock covers the
        # hit check, the build, and the LRU bound. Holding it through the
        # build serializes tree construction, which the single device
        # serializes anyway (same reasoning as the coalescer's one worker).
        # It also keeps the builds that switch on deterministic algorithms
        # (process-wide: ML on a mesh, refine "search") one at a time. On a
        # mesh a miss is a mesh job (every rank builds); a hit runs no
        # collective.
        with self._tree_lock:
            cached_tree = tkey in self.tree_cache
            if cached_tree or self._mesh is None:
                result = engine.build(entry["msa"], cache=self.tree_cache,
                                      cache_key=tkey)
            else:
                result = self._mesh.run("tree", np.asarray(entry["msa"]),
                                        kw)
                self.tree_cache[tkey] = result
            self.tree_cache.move_to_end(tkey)
            while len(self.tree_cache) > self.cfg.tree_cache_items:
                self.tree_cache.popitem(last=False)
        resp = {"msa_id": msa_id, "newick": result.newick(entry["names"]),
                "backend": result.backend, "requested_backend": be,
                "refine": refine,
                "n_leaves": result.n_leaves, "cached_tree": cached_tree,
                "cache": self.cache.stats(),
                "elapsed_ms": (time.perf_counter() - t0) * 1e3}
        if store_entry is not None:
            resp["name"] = store_entry.name
            resp["generation"] = store_entry.generation
            resp["fingerprint"] = store_entry.fingerprint
        if result.logl is not None:
            resp["model"] = result.model
            resp["logl"] = result.logl
        return resp

    def search(self, names: Sequence[str], seqs: Sequence[str], *,
               max_hits: Optional[int] = None,
               min_coverage: Optional[float] = None,
               max_evalue: Optional[float] = None) -> dict:
        """Per-query top-k database hits, content-hash cached.

        The cache key spans everything that changes the result: the
        database fingerprint, the search config, the effective gates,
        and the canonicalized query set — so a permuted resubmission of
        the same queries hits, and hits are mapped back to the caller's
        order through the canonicalization permutation (same contract
        as ``/align``).
        """
        with self._request("search") as tid:
            return dict(self._search_impl(names, seqs, max_hits=max_hits,
                                          min_coverage=min_coverage,
                                          max_evalue=max_evalue),
                        trace_id=tid)

    def _search_impl(self, names: Sequence[str], seqs: Sequence[str], *,
                     max_hits: Optional[int] = None,
                     min_coverage: Optional[float] = None,
                     max_evalue: Optional[float] = None) -> dict:
        if self.search_engine is None:
            raise ValueError("no search database configured "
                             "(serve_msa --search-db)")
        t0 = time.perf_counter()
        names, seqs = list(names), list(seqs)
        eng = self.search_engine
        max_hits = eng.cfg.max_hits if max_hits is None else int(max_hits)
        min_coverage = (eng.cfg.min_coverage if min_coverage is None
                        else float(min_coverage))
        max_evalue = (eng.cfg.max_evalue if max_evalue is None
                      else float(max_evalue))
        canon, perm = canonicalize(seqs)
        key = canonical_key(canon, f"search/{self._search_db_fp}/"
                                   f"{eng.cfg.fingerprint()}/{max_hits}/"
                                   f"{min_coverage}/{max_evalue}")
        entry = self.cache.get(key)
        cached = entry is not None
        if not cached:
            run = (self._mesh_search if self._mesh is None
                   else lambda *a: self._mesh.run("search", *a))
            result = run(canon, max_hits, min_coverage, max_evalue)
            entry = {"hits": [q["hits"] for q in result["queries"]],
                     "lengths": [q["length"] for q in result["queries"]],
                     "stats": result["stats"]}
            self.cache.put(key, entry, len(json.dumps(entry)))
        inv = [0] * len(perm)
        for i, p in enumerate(perm):
            inv[p] = i
        return {"search_id": key,
                "queries": [{"name": names[j],
                             "length": entry["lengths"][inv[j]],
                             "hits": entry["hits"][inv[j]]}
                            for j in range(len(seqs))],
                "stats": entry["stats"], "cached": cached,
                "cache": self.cache.stats(),
                "elapsed_ms": (time.perf_counter() - t0) * 1e3}

    def stats_snapshot(self) -> dict:
        """Cache + queue stats from one instant.

        Both locks are held together (cache first, then queue — the one
        fixed order in the codebase, so no deadlock is possible) instead
        of reading ``cache.stats()`` and ``coalescer.stats()`` at
        different times, which could disagree under load.
        """
        with self.cache.lock:
            with self.coalescer.lock:
                return {"cache": self.cache.stats_locked(),
                        "queue": self.coalescer.stats_locked()}

    def healthz(self) -> dict:
        snap = self.stats_snapshot()
        return {"status": "draining" if self._draining else "ok",
                "uptime_s": round(time.time() - self._t0, 3),
                "alphabet": self.cfg.alphabet, "method": self.cfg.method,
                "backend": self.engine.route,
                "active_requests": self._active,
                "cache": snap["cache"],
                "queue": snap["queue"],
                "store": (self.store.stats()
                          if self.store is not None else None),
                "search_db": (self.cfg.search_index.n_seqs
                              if self.cfg.search_index is not None
                              else None)}

    def statusz(self) -> str:
        """Human-readable plain-text snapshot (``GET /statusz``)."""
        h = self.healthz()
        lines = [
            "repro_torch.serve statusz",
            f"status           {h['status']}",
            f"uptime_s         {h['uptime_s']}",
            f"config           alphabet={h['alphabet']} method={h['method']}"
            f" backend={h['backend']}",
            f"active_requests  {h['active_requests']}",
            f"search_db_seqs   {h['search_db']}",
            "",
            "cache   " + " ".join(f"{k}={v}" for k, v in h["cache"].items()),
            "queue   " + " ".join(f"{k}={v}" for k, v in h["queue"].items()),
        ]
        if h["store"] is not None:
            st = dict(h["store"])
            gens = st.pop("generations")
            lines.append("store   " + " ".join(f"{k}={v}"
                                               for k, v in st.items()))
            for n, g in gens.items():
                e = self.store.get(n)
                lines.append(f"  {n:<16} generation={g} width={e.width} "
                             f"members={len(e.names)} "
                             f"fingerprint={e.fingerprint[:12]}")
        lines += [
            "",
            "requests (started == finished + rejected):",
        ]
        snap = _obs.REGISTRY.snapshot()
        for fam in ("repro_requests_started_total",
                    "repro_requests_finished_total",
                    "repro_requests_rejected_total"):
            for s in snap.get(fam, {}).get("samples", []):
                lbl = ",".join(f"{k}={v}" for k, v in s["labels"].items())
                lines.append(f"  {fam}{{{lbl}}} {int(s['value'])}")
        lines.append("")
        lines.append("recent root spans:")
        roots = [r for r in _trace.TRACER.spans() if r.parent_id is None]
        for r in roots[-10:]:
            lines.append(f"  {r.name:<16} {r.duration * 1e3:9.2f} ms"
                         f"  trace_id={r.trace_id}")
        return "\n".join(lines) + "\n"

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Refuse new work, wait for in-flight requests, flush the queue.

        Blocks until every request that entered ``_request`` before the
        drain flag flipped has finished (or ``timeout`` elapses); then
        stops the mesh's followers (rank 0) and drains the coalescer.
        Returns False only on timeout.
        """
        with self._active_cond:
            self._draining = True
            done = self._active_cond.wait_for(lambda: self._active == 0,
                                              timeout)
        if self._mesh is not None:
            self._mesh.stop()
        self.coalescer.close()
        if self.store is not None:
            # queued realigns finish and swap before exit; their commits
            # are atomic either way, so this only buys wall-clock
            self.store.close(wait=True)
        return done


# ------------------------------------------------------------- HTTP layer

class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):            # stay quiet under test
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _send(self, code: int, obj: dict):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_text(self, code: int, text: str,
                   content_type: str = "text/plain; charset=utf-8"):
        data = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _payload(self) -> dict:
        n = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(n) if n else b""
        return json.loads(body or b"{}")

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, self.server.service.healthz())
        elif self.path == "/metrics":
            # the content type Prometheus scrapers expect for text format
            self._send_text(200, _obs.REGISTRY.render(),
                            "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/statusz":
            self._send_text(200, self.server.service.statusz())
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        from urllib.parse import parse_qs, urlsplit

        svc: MSAService = self.server.service
        try:
            parts = urlsplit(self.path)
            path = parts.path
            payload = self._payload()
            # ?name=x and {"name": "x"} are equivalent; the body wins
            qs_name = parse_qs(parts.query).get("name", [None])[0]
            name = payload.get("name") or qs_name
            if path == "/align":
                if name is not None:
                    has_seqs = "fasta" in payload or "sequences" in payload
                    names, seqs = (parse_sequences(payload)
                                   if has_seqs else (None, None))
                    self._send(200, svc.align_named(name, names, seqs))
                else:
                    names, seqs = parse_sequences(payload)
                    self._send(200, svc.align(names, seqs))
            elif path == "/align/add":
                if name is None and "msa_id" not in payload:
                    raise ValueError("align/add needs 'msa_id' or 'name'")
                names, seqs = parse_sequences(payload)
                self._send(200, svc.align_add(payload.get("msa_id"),
                                              names, seqs, name=name))
            elif path == "/tree":
                tree_kw = {k: payload.get(k) for k in
                           ("backend", "refine", "model", "bootstrap",
                            "seed")}
                if name is not None:
                    self._send(200, svc.tree(name=name, **tree_kw))
                elif "msa_id" in payload:
                    self._send(200, svc.tree(msa_id=payload["msa_id"],
                                             **tree_kw))
                else:
                    names, seqs = parse_sequences(payload)
                    self._send(200, svc.tree(names=names, seqs=seqs,
                                             **tree_kw))
            elif path == "/search":
                names, seqs = parse_sequences(payload)
                kw = {k: payload.get(k) for k in
                      ("max_hits", "min_coverage", "max_evalue")}
                self._send(200, svc.search(names, seqs, **kw))
            else:
                self._send(404, {"error": f"unknown path {self.path}"})
        except KeyError as e:
            self._send(404, {"error": str(e)})
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
        except _StoreError as e:
            self._send(409, {"error": str(e)})
        except RuntimeError as e:
            self._send(503, {"error": str(e)})


class MSAHTTPServer(ThreadingHTTPServer):
    # non-daemon handler threads + block_on_close: server_close() waits
    # for in-flight requests — the graceful half of drain-on-shutdown
    daemon_threads = False
    block_on_close = True
    service: MSAService
    verbose: bool = False


def serve_http(service: MSAService, host: str = "127.0.0.1",
               port: int = 8642, verbose: bool = False) -> MSAHTTPServer:
    """Bind the HTTP front end; caller runs ``serve_forever()`` and on
    shutdown calls ``shutdown(); server_close(); service.drain()``."""
    httpd = MSAHTTPServer((host, port), _Handler)
    httpd.service = service
    httpd.verbose = verbose
    return httpd
