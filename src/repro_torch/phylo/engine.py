"""TreeEngine: the backend-dispatching phylogeny engine of the port.

One entry point for every tree path of the port — ``launch/msa_run.py
--tree`` and the aligned-FASTA launcher ``launch/tree_run.py``.

Backends (``TREE_BACKENDS``):

  dense     (N, N) matrix + monolithic NJ on the device — exact
  tiled     streamed HPTree pipeline over distance tiles
            (``repro_torch.phylo.pipeline``) — resident distance storage
            <= one (row_block, N) strip; resolves to ``tiled-exact``
            (tile-assembled matrix + monolithic NJ, still within budget)
            when N <= row_block
  cluster   the dense HPTree cluster-merge (``core.cluster``) — scalable
            compute, but still materializes the (0.1 N)^2 sample matrix
  auto      dense at or below ``cluster_threshold``; tiled above
            ``AUTO_TILED_N``; cluster otherwise

Any backend's tree can then be **refined**: ``refine="ml"`` runs the
``repro_torch.phylo.ml`` MLRefiner — branch lengths by autodiff,
substitution model by BIC (``model="auto"``), topology by NNI;
``refine="search"`` runs the ``repro_torch.phylo.treesearch`` multi-start
fleet instead (``starts`` searches mixing NNI with bounded-radius SPR,
restartable through ``ckpt_dir``/``resume``). Either mode plus
``bootstrap=B`` attaches nonparametric bootstrap support to every
internal edge. The alignment's site patterns are compressed once for
both.

Every distance count comes from the match/valid kernel on the card (its
plain version with ``device="cpu"``). With a ``mesh`` (a
``repro_torch.dist.sharding.Mesh``) the tiled backend's strips and
assignment, ML bootstrap replicates and the search fleet's candidate
scoring split over its ranks; every other stage runs on every rank, and
every rank returns the same result.

``build`` returns a ``PhyloResult``: the tree arrays, the effective backend
that ran (``"<backend>+ml"``/``"+search"`` when refined), timings, for the
tiled backends the tile accountant's memory stats, and for refined trees
the model, logL before/after, per-model BIC, accepted moves and per-node
support.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core import cluster as cluster_mod
from ..core import distance as dist_mod
from ..core import nj as nj_mod
from ..core import treeio
from ..device import resolve_device, sync
from ..obs import metrics as _obs
from ..obs import trace as _trace
from . import pipeline, tiles

_M_BUILDS = _obs.counter("repro_tree_builds_total",
                         "tree reconstructions by effective backend",
                         ("backend",))

TREE_BACKENDS = ("auto", "dense", "tiled", "cluster")
REFINE_MODES = ("none", "ml", "search")

# above this N, `auto` prefers the tiled pipeline even on one device: the
# dense cluster path's (0.1 N)^2 sample matrix starts to dominate memory
AUTO_TILED_N = 4096


class PhyloResult(NamedTuple):
    children: np.ndarray     # (2N-1, 2) int32, -1 children marks a leaf
    blen: np.ndarray         # (2N-1, 2) float32 branch lengths
    root: int
    n_leaves: int
    backend: str             # effective backend that ran (see resolve)
    requested: str           # what the caller asked for
    timings: Dict[str, float]
    tile_stats: Optional[dict] = None   # accountant stats, tiled backends
    logl: Optional[Dict[str, float]] = None   # {"initial", "final"} (ml)
    model: Optional[str] = None               # fitted substitution model
    support: Optional[np.ndarray] = None      # per-node bootstrap support
    bic: Optional[Dict[str, float]] = None    # per-candidate-model BIC
    n_nni: Optional[int] = None               # accepted topology moves
    search: Optional[dict] = None             # fleet stats (refine=search)

    def newick(self, names=None) -> str:
        return treeio.to_newick(self.children, self.blen, self.root, names,
                                support=self.support)


def resolve_tree_backend(backend: str, *, n: int, mesh=None,
                         cluster_threshold: int = 64,
                         row_block: int = 128) -> str:
    """Map a requested backend + problem geometry to the one that runs.

    ``cluster`` drops to ``dense`` at or below ``cluster_threshold``;
    ``tiled`` becomes ``tiled-exact`` when the whole matrix fits one
    strip; ``auto`` takes the tiled pipeline on a mesh of more than one
    rank.
    """
    if backend not in TREE_BACKENDS:
        raise ValueError(f"unknown tree backend {backend!r}; "
                         f"expected one of {TREE_BACKENDS}")
    if backend == "auto":
        if n <= cluster_threshold:
            return "dense"
        if (mesh is not None and mesh.size > 1) or n > AUTO_TILED_N:
            return "tiled" if n > row_block else "tiled-exact"
        return "cluster"
    if backend == "cluster" and n <= cluster_threshold:
        return "dense"
    if backend == "tiled" and n <= row_block:
        return "tiled-exact"
    return backend


@dataclasses.dataclass(frozen=True)
class TreeEngine:
    """One configured tree engine on ``device``."""

    gap_code: int
    n_chars: int
    correct: bool = True             # JC69 correction (off for protein)
    backend: str = "auto"
    cluster_threshold: int = 64
    row_block: int = 128
    col_block: Optional[int] = None
    target_cluster: int = 64
    sample_frac: float = 0.10
    seed: int = 0
    mesh: Optional[object] = None    # a dist.sharding.Mesh
    refine: str = "none"             # none | ml | search
    model: str = "auto"              # substitution model (auto = BIC)
    bootstrap: int = 0               # bootstrap replicates (ml/search)
    ml_steps: int = 150              # adam steps per ML fit
    nni_rounds: int = 8              # max accepted NNI rounds
    starts: int = 4                  # refine=search: fleet size K
    spr_radius: int = 3              # refine=search: SPR regraft radius
    search_rounds: int = 12          # refine=search: max move rounds
    ckpt_dir: Optional[str] = None   # refine=search: per-round checkpoints
    resume: bool = False             # refine=search: resume from ckpt_dir
    device: str = "cuda"

    def cluster_cfg(self) -> cluster_mod.ClusterConfig:
        return cluster_mod.ClusterConfig(sample_frac=self.sample_frac,
                                         target_cluster=self.target_cluster,
                                         seed=self.seed, correct=self.correct)

    def tile_ctx(self, accountant: Optional[tiles.TileAccountant] = None
                 ) -> tiles.TileContext:
        return tiles.TileContext(gap_code=self.gap_code, n_chars=self.n_chars,
                                 correct=self.correct,
                                 row_block=self.row_block,
                                 col_block=self.col_block, mesh=self.mesh,
                                 accountant=accountant, device=self.device)

    def resolve(self, n: int) -> str:
        return resolve_tree_backend(self.backend, n=n, mesh=self.mesh,
                                    cluster_threshold=self.cluster_threshold,
                                    row_block=self.row_block)

    def build(self, msa, *,
              accountant: Optional[tiles.TileAccountant] = None,
              cache: Optional[dict] = None,
              cache_key: Optional[str] = None) -> PhyloResult:
        """Reconstruct a tree from aligned (N, L) int8 rows.

        With a mutable ``cache`` and a ``cache_key``, a hit returns the
        stored ``PhyloResult`` without touching the distance machinery and
        a miss stores the new result under that key; the caller owns the
        mapping.
        """
        if self.refine not in REFINE_MODES:
            raise ValueError(f"unknown refine mode {self.refine!r}; "
                             f"expected one of {REFINE_MODES}")
        if self.refine != "none" and self.n_chars > 5:
            raise ValueError(f"refine={self.refine!r} needs a nucleotide "
                             "alphabet (4-state likelihood); got n_chars="
                             f"{self.n_chars}")
        if self.bootstrap > 0 and self.refine == "none":
            raise ValueError("bootstrap support requires refine='ml' or "
                             f"'search' (got bootstrap={self.bootstrap} "
                             f"with refine={self.refine!r})")
        if cache is not None and cache_key is not None and cache_key in cache:
            return cache[cache_key]
        dev = resolve_device(self.device)
        if not isinstance(msa, torch.Tensor):
            msa = torch.from_numpy(np.array(msa))
        msa_t = msa.to(dev)
        n = msa_t.shape[0]
        if n < 2:
            raise ValueError(f"need >= 2 sequences for a tree, got {n}")
        eff = self.resolve(n)
        acct = accountant or tiles.TileAccountant()

        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        with _trace.span("tree", backend=eff, n=n):
            if eff in ("dense", "tiled-exact"):
                with _trace.span("tree.distance", backend=eff, n=n):
                    if eff == "dense":
                        D = dist_mod.distance_matrix(
                            msa_t, gap_code=self.gap_code,
                            n_chars=self.n_chars, correct=self.correct)
                        sync(dev)
                    else:
                        ctx = self.tile_ctx(acct)
                        D_host = ctx.full(msa_t)
                        D = torch.from_numpy(D_host).to(dev)
                        ctx.release(D_host)
                with _trace.span("tree.nj", n=n):
                    children, blen, root = nj_mod.host_tree(
                        nj_mod.neighbor_joining(D, n))
            else:
                # the HPTree stages run under the distance span, with one
                # child span per stage
                with _trace.span("tree.distance", backend=eff, n=n):
                    if eff == "tiled":
                        cp = pipeline.tiled_phylogeny(
                            msa_t, tiles=self.tile_ctx(acct),
                            cfg=self.cluster_cfg())
                    else:   # cluster
                        cp = cluster_mod.cluster_phylogeny(
                            msa_t, gap_code=self.gap_code,
                            n_chars=self.n_chars, cfg=self.cluster_cfg())
                children, blen, root = cp.children, cp.blen, cp.root
            refined = {}
            if self.refine != "none":
                refined = self._refine(msa_t, children, blen, root, timings)
                children, blen, root = refined.pop("tree")
                eff = f"{eff}+{self.refine}"
        timings["total_seconds"] = time.perf_counter() - t0
        tile_stats = None
        if eff.startswith("tiled"):
            tile_stats = dict(acct.stats(),
                              row_block_bytes=self.row_block * n * 4)
        _M_BUILDS.labels(backend=eff).inc()
        result = PhyloResult(np.asarray(children), np.asarray(blen),
                             int(root), n, eff, self.backend, timings,
                             tile_stats, **refined)
        if cache is not None and cache_key is not None:
            cache[cache_key] = result
        return result

    def _refine(self, msa_t, children, blen, root, timings) -> dict:
        """ML refinement or the search fleet, then bootstrap support, on
        the backend's tree; returns the ``PhyloResult`` fields (and the
        new tree under ``"tree"``)."""
        from ..core import likelihood as lik
        from .ml import MLRefiner
        refiner = MLRefiner(gap_code=self.gap_code, n_chars=self.n_chars,
                            correct=self.correct, model=self.model,
                            steps=self.ml_steps, nni_rounds=self.nni_rounds,
                            seed=self.seed, mesh=self.mesh,
                            device=self.device)
        # compress once; refine/search and bootstrap share the patterns
        patterns, weights = lik.compress_patterns(msa_t)
        out = {}
        if self.refine == "ml":
            with _trace.span("tree.refine", model=self.model) as sp:
                t1 = time.perf_counter()
                res = refiner.refine(msa_t, children, blen, root,
                                     patterns=patterns, weights=weights)
            n_moves = res.n_nni
        else:
            # the fleet builds its own starting trees (NJ among them); the
            # backend tree above stays the distance stage's product
            from .treesearch import TreeSearcher
            searcher = TreeSearcher(
                gap_code=self.gap_code, n_chars=self.n_chars,
                correct=self.correct, starts=self.starts,
                spr_radius=self.spr_radius, rounds=self.search_rounds,
                model=self.model, steps=self.ml_steps, seed=self.seed,
                mesh=self.mesh, ckpt_dir=self.ckpt_dir, resume=self.resume,
                device=self.device)
            with _trace.span("tree.refine", model=self.model,
                             mode="search") as sp:
                t1 = time.perf_counter()
                res = searcher.search(msa_t, patterns=patterns,
                                      weights=weights)
            n_moves = int(res.n_moves.sum())
            out["search"] = {
                "best_start": res.best_start,
                "start_labels": list(res.start_labels),
                "trajectories": np.asarray(res.trajectories).tolist(),
                "n_moves": np.asarray(res.n_moves).tolist(),
                "round_seconds": np.asarray(res.round_seconds).tolist()}
        timings["refine_seconds"] = (sp.duration if sp is not None
                                     else time.perf_counter() - t1)
        out.update(tree=(res.children, res.blen, res.root),
                   logl={"initial": res.logl_init, "final": res.logl_final},
                   model=res.model, bic=res.bic, n_nni=n_moves)
        if self.bootstrap > 0:
            with _trace.span("tree.bootstrap",
                             replicates=self.bootstrap) as sp:
                t1 = time.perf_counter()
                out["support"] = refiner.bootstrap(
                    msa_t, res.children, res.blen, res.root, self.bootstrap,
                    patterns=patterns, weights=weights)
            timings["bootstrap_seconds"] = (sp.duration if sp is not None
                                            else time.perf_counter() - t1)
        return out
