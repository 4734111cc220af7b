"""TreeEngine: the phylogeny engine of the port.

Only the ``dense`` backend with ``refine="none"`` is ported: the (N, N)
JC69 distance matrix (counts from the match/valid kernel on the card)
and monolithic neighbor joining on the device. ``auto`` resolves to
``dense`` at or below ``cluster_threshold``; every other backend and
refine mode raises ``NotImplementedError`` naming its ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core import distance as dist_mod
from ..core import nj as nj_mod
from ..core import treeio
from ..device import resolve_device, sync
from ..obs import metrics as _obs
from ..obs import trace as _trace

_M_BUILDS = _obs.counter("repro_tree_builds_total",
                         "tree reconstructions by effective backend",
                         ("backend",))

TREE_BACKENDS = ("auto", "dense", "tiled", "cluster")
REFINE_MODES = ("none", "ml", "search")
_TODO = "ROADMAP.md §1 item 8 (tree backends)"
_TODO_REFINE = "ROADMAP.md §1 item 9 (likelihood and ML)"


class PhyloResult(NamedTuple):
    children: np.ndarray     # (2N-1, 2) int32, -1 children marks a leaf
    blen: np.ndarray         # (2N-1, 2) float32 branch lengths
    root: int
    n_leaves: int
    backend: str             # effective backend that ran
    requested: str           # what the caller asked for
    timings: Dict[str, float]

    def newick(self, names=None) -> str:
        return treeio.to_newick(self.children, self.blen, self.root, names)


def resolve_tree_backend(backend: str, *, n: int,
                         cluster_threshold: int = 64) -> str:
    """Map a requested backend + problem size to the one that runs."""
    if backend not in TREE_BACKENDS:
        raise ValueError(f"unknown tree backend {backend!r}; "
                         f"expected one of {TREE_BACKENDS}")
    if backend == "dense" or (backend in ("auto", "cluster")
                              and n <= cluster_threshold):
        return "dense"
    raise NotImplementedError(
        f"tree backend {backend!r} at n={n} is not ported yet ({_TODO})")


@dataclasses.dataclass(frozen=True)
class TreeEngine:
    """One configured tree engine on ``device``."""

    gap_code: int
    n_chars: int
    correct: bool = True             # JC69 correction (off for protein)
    backend: str = "auto"
    cluster_threshold: int = 64
    refine: str = "none"
    device: str = "cuda"

    def build(self, msa) -> PhyloResult:
        """Reconstruct a tree from aligned (N, L) int8 rows."""
        if self.refine not in REFINE_MODES:
            raise ValueError(f"unknown refine mode {self.refine!r}; "
                             f"expected one of {REFINE_MODES}")
        if self.refine != "none":
            raise NotImplementedError(
                f"refine={self.refine!r} is not ported yet ({_TODO_REFINE})")
        dev = resolve_device(self.device)
        msa_t = torch.as_tensor(np.asarray(msa), device=dev)
        n = msa_t.shape[0]
        if n < 2:
            raise ValueError(f"need >= 2 sequences for a tree, got {n}")
        eff = resolve_tree_backend(self.backend, n=n,
                                   cluster_threshold=self.cluster_threshold)
        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        with _trace.span("tree", backend=eff, n=n):
            with _trace.span("tree.distance", backend=eff, n=n):
                D = dist_mod.distance_matrix(msa_t, gap_code=self.gap_code,
                                             n_chars=self.n_chars,
                                             correct=self.correct)
                sync(dev)
            with _trace.span("tree.nj", n=n):
                children, blen, root = nj_mod.host_tree(
                    nj_mod.neighbor_joining(D, n))
        timings["total_seconds"] = time.perf_counter() - t0
        _M_BUILDS.labels(backend=eff).inc()
        return PhyloResult(children, blen, root, n, eff, self.backend,
                           timings)
