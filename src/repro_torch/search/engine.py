"""SearchEngine: batched query-vs-database homology search.

The port of ``repro.search.engine``:

  seed      every (query, DB row) pair runs the k-mer anchor chaining of
            ``core.kmer_index`` against that row's table from the
            ``SearchIndex``; the accepted-anchor count is the prefilter
            score, and pairs below ``min_anchors`` never reach the DP. The
            pairs are chained on the device in chunks of DB rows, so the
            per-pair tables and the (pairs, T, r) candidate tensor stay
            under ``SEED_BUDGET`` bytes. On a mesh the DB's tables split
            over the data axis and the count matrix is gathered
            (``dist.mapreduce.search_over_mesh``).
  rescore   surviving pairs go through ``AlignEngine.align_pairs``: the
            full-DP kernel (local or global) or, under ``--backend
            banded``/``banded-pallas``, the banded kernels; raw scores
            become bit scores / e-values (``search.evalue``).

Host reduction: per-query hits are gated (``max_evalue``,
``min_coverage``), ordered by (score desc, db index asc) — a total,
deterministic order — and truncated to ``max_hits``, exactly as in the
reference. Counts are per-pair integers, so hits are the same on every
mesh shape.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import alphabet as ab
from ..core import kmer_index
from ..device import resolve_device, sync
from ..obs import metrics as _obs
from ..obs import trace as _trace
from . import evalue as ev
from .index import SearchIndex

_C_QUERIES = _obs.counter("repro_search_queries_total", "queries searched")
_C_PAIRS = _obs.counter("repro_search_pairs_total",
                        "(query, db row) pairs considered by the prefilter")
_C_CAND = _obs.counter("repro_search_candidates_total",
                       "pairs surviving the seed prefilter into rescoring")
_G_SURVIVAL = _obs.gauge("repro_search_survival_ratio",
                         "prefilter survival of the last search call")
_H_RESCORE = _obs.histogram("repro_search_rescore_seconds",
                            "wall-clock of the DP rescoring stage")

# bytes of per-pair tables and candidate tensors one seed chunk may hold
SEED_BUDGET = 2 << 30


def seed_counts_batch(Q, qlens, dblens, tables, *, k: int, stride: int,
                      max_anchors: int, max_seg: int):
    """(B, D) accepted-anchor counts: every query chained against every
    database row's k-mer table, on the tensors' device.

    Q (B, n) int8, qlens (B,), dblens (D,), tables (D, 4^k, r) int32.
    Pairs run in chunks of DB rows (query-major within a chunk).
    """
    B, n = Q.shape
    D = tables.shape[0]
    dev = Q.device
    counts = torch.zeros((B, D), dtype=torch.int32, device=dev)
    if B == 0 or D == 0:
        return counts
    # a pair holds its table copy and ~3 (T, r) int32 candidate tensors
    per_pair = 4 * tables[0].numel() + 12 * max(n - k + 1, 1) * tables.shape[2]
    rows = max(1, min(D, SEED_BUDGET // (per_pair * B)))
    qi = torch.arange(B, device=dev)
    for d0 in range(0, D, rows):
        d1 = min(D, d0 + rows)
        qq = qi[:, None].expand(B, d1 - d0).reshape(-1)
        dd = torch.arange(d0, d1, device=dev)[None, :].expand(
            B, d1 - d0).reshape(-1)
        anch = kmer_index.chain_anchors(
            Q[qq], qlens[qq], tables[dd], dblens[dd], k=k, stride=stride,
            max_anchors=max_anchors, max_seg=max_seg)
        counts[:, d0:d1] = anch.count.view(B, d1 - d0)
    return counts


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Everything that changes a search result (part of the cache key)."""
    alphabet: str = "dna"        # dna | rna (base-4 seeding)
    k: int = 6                   # seeding k-mer width (index build)
    stride: int = 1              # query probe stride
    max_anchors: int = 32        # prefilter count saturation
    chain_seg: int = 1 << 20     # chaining segment budget: effectively
                                 # unlimited — a DB hit may sit anywhere
    min_anchors: int = 1         # seed survival threshold
    max_hits: int = 10           # per-query top-k
    min_coverage: float = 0.0    # aligned-column coverage of the query
    max_evalue: float = 10.0
    match: int = 2
    mismatch: int = -1
    gap_open: int = 3
    gap_extend: int = 1
    local: bool = True           # Smith-Waterman rescoring (vs global)
    backend: str = "auto"        # align backend name (see align.backends)
    band: int = 64
    lam: float = ev.DEFAULT_LAMBDA
    k_const: float = ev.DEFAULT_K

    def alpha(self) -> ab.Alphabet:
        return {"dna": ab.DNA, "rna": ab.RNA}[self.alphabet]

    def matrix(self, device="cuda") -> torch.Tensor:
        return torch.as_tensor(ab.dna_matrix(self.match, self.mismatch),
                               dtype=torch.float32,
                               device=resolve_device(device))

    def engine(self, device="cuda"):
        from ..align.engine import AlignEngine
        return AlignEngine(self.matrix(device), gap_open=self.gap_open,
                           gap_extend=self.gap_extend,
                           gap_code=self.alpha().gap_code,
                           backend=self.backend, band=self.band,
                           local=self.local)

    def fingerprint(self) -> str:
        return (f"{self.alphabet}/{self.k}/{self.stride}/{self.max_anchors}/"
                f"{self.chain_seg}/{self.min_anchors}/{self.match}/"
                f"{self.mismatch}/{self.gap_open}/{self.gap_extend}/"
                f"{self.local}/{self.backend}/{self.band}/"
                f"{self.lam}/{self.k_const}")


@dataclasses.dataclass(frozen=True)
class SearchEngine:
    """One configured search engine on ``device`` (raises when CUDA is
    asked for and absent); ``mesh`` (a ``dist.sharding.Mesh``) splits the
    seed stage over its data axis."""

    cfg: SearchConfig = SearchConfig()
    mesh: Optional[object] = None
    data_axis: str = "data"
    device: str = "cuda"

    def __post_init__(self):
        resolve_device(self.device)

    # ------------------------------------------------------------ index

    def build_index(self, names: Sequence[str],
                    seqs: Sequence[str]) -> SearchIndex:
        return SearchIndex.build(names, seqs, k=self.cfg.k,
                                 alphabet=self.cfg.alphabet,
                                 device=self.device)

    # ------------------------------------------------------------- seed

    def _encode_queries(self, seqs: Sequence[str]):
        norm = [s.replace("U", "T").replace("u", "t")
                if self.cfg.alphabet == "rna" else s for s in seqs]
        Q, qlens = ab.encode_batch(norm, self.cfg.alpha())
        if Q.shape[1] == 0:                    # all-empty query batch
            Q, qlens = ab.encode_batch(norm, self.cfg.alpha(), pad_to=1)
        return Q, qlens

    def seed_counts(self, Q, qlens, index: SearchIndex) -> np.ndarray:
        """(B, D) anchor counts, computed on the engine's device; split
        over the DB on a mesh (tables sharded, queries on every rank)."""
        cfg = self.cfg
        dev = resolve_device(self.device)
        if self.mesh is not None:
            from ..dist import mapreduce
            fn = mapreduce.search_over_mesh(
                self.mesh, k=index.k, stride=cfg.stride,
                max_anchors=cfg.max_anchors, max_seg=cfg.chain_seg,
                data_axis=self.data_axis)
            counts = fn(torch.as_tensor(Q, device=dev),
                        torch.as_tensor(qlens, device=dev).to(torch.int32),
                        mapreduce.shard_padded(index.lens, self.mesh,
                                               self.data_axis),
                        mapreduce.shard_padded(index.tables, self.mesh,
                                               self.data_axis))
            return counts[:, :index.n_seqs].cpu().numpy()
        counts = seed_counts_batch(
            torch.as_tensor(Q, device=dev),
            torch.as_tensor(qlens, device=dev).to(torch.int32),
            torch.as_tensor(index.lens, device=dev),
            torch.as_tensor(index.tables, device=dev),
            k=index.k, stride=cfg.stride, max_anchors=cfg.max_anchors,
            max_seg=cfg.chain_seg)
        return counts.cpu().numpy()

    # ----------------------------------------------------------- search

    def search(self, names: Sequence[str], seqs: Sequence[str],
               index: SearchIndex, *, max_hits: Optional[int] = None,
               min_coverage: Optional[float] = None,
               max_evalue: Optional[float] = None,
               exhaustive: bool = False) -> dict:
        """Top-k hits for every query; gates default to the config's.

        ``exhaustive=True`` skips the seed prefilter and rescores every
        (query, DB) pair — the small-scale oracle of prefilter recall.
        """
        cfg = self.cfg
        if index.alphabet != cfg.alphabet:
            raise ValueError(f"index alphabet {index.alphabet!r} != engine "
                             f"alphabet {cfg.alphabet!r}")
        max_hits = cfg.max_hits if max_hits is None else int(max_hits)
        min_coverage = (cfg.min_coverage if min_coverage is None
                        else float(min_coverage))
        max_evalue = cfg.max_evalue if max_evalue is None else float(max_evalue)

        names = list(names)
        Q, qlens = self._encode_queries(seqs)
        B = Q.shape[0]
        seed = "mesh" if self.mesh is not None else "host"
        with _trace.span("search.seed", n_queries=B, db_seqs=index.n_seqs,
                         seed=seed):
            counts = self.seed_counts(Q, qlens, index)      # (B, D)

        cand = (np.ones_like(counts, bool) if exhaustive
                else counts >= cfg.min_anchors)
        qi, di = np.nonzero(cand)                            # row-major:
        n_cand = len(qi)                                     # deterministic
        _C_QUERIES.inc(B)
        _C_PAIRS.inc(B * index.n_seqs)
        _C_CAND.inc(n_cand)
        _G_SURVIVAL.set(n_cand / max(B * index.n_seqs, 1))

        per_query: List[List[dict]] = [[] for _ in range(B)]
        n_calls = 0
        if n_cand:
            engine = cfg.engine(self.device)
            t0 = time.perf_counter()
            with _trace.span("search.rescore", pairs=n_cand) as sp:
                res = engine.align_pairs(Q[qi], qlens[qi],
                                         index.S[di], index.lens[di])
                if sp is not None:
                    sync(engine.device)
            _H_RESCORE.observe(sp.duration if sp is not None
                               else time.perf_counter() - t0)
            n_calls = res.n_calls
            scores = res.score.cpu().numpy().astype(np.float32)
            gap = cfg.alpha().gap_code
            a = res.a_row.cpu().numpy()
            b = res.b_row.cpu().numpy()
            aligned = ((a != gap) & (b != gap)).sum(axis=1)
            cov = aligned / np.maximum(qlens[qi], 1)
            bits = ev.bit_scores(scores, lam=cfg.lam, k_const=cfg.k_const)
            evals = ev.evalues(scores, qlens[qi], index.db_residues,
                               lam=cfg.lam, k_const=cfg.k_const)
            keep = (evals <= max_evalue) & (cov >= min_coverage)
            # total order: query, score desc, db index asc
            order = sorted(np.nonzero(keep)[0].tolist(),
                           key=lambda j: (qi[j], -scores[j], di[j]))
            for j in order:
                q = int(qi[j])
                if len(per_query[q]) >= max_hits:
                    continue
                d = int(di[j])
                per_query[q].append({
                    "target": index.names[d], "db_idx": d,
                    "score": float(scores[j]),
                    "bits": round(float(bits[j]), 4),
                    "evalue": float(evals[j]),
                    "coverage": round(float(cov[j]), 4),
                    "anchors": int(counts[q, d])})

        return {
            "queries": [{"name": names[i], "length": int(qlens[i]),
                         "hits": per_query[i]} for i in range(B)],
            "stats": {
                "db_seqs": index.n_seqs,
                "db_residues": index.db_residues,
                "candidates": n_cand,
                "survival": round(n_cand / max(B * index.n_seqs, 1), 4),
                "align_calls": n_calls,
                "seed": seed,
                "exhaustive": bool(exhaustive)}}
