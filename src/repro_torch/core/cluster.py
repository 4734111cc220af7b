"""HPTree-style cluster-then-merge phylogeny (paper Fig. 4).

Stages, mirroring the paper: (1) random-sample ~10% of sequences; (2) pick k
medoids among the sample (farthest-point greedy over the sampled distance
matrix); (3) assign every sequence to its nearest medoid — one (N, k)
cross-distance; (4) rebalance oversized clusters by spilling overflow to the
next-nearest medoid with room; (5) NJ per cluster, batched over padded
distance matrices that one kernel launch counts
(``distance.distance_groups``); (6) NJ skeleton over the medoids and
stitch the cluster subtrees into the final tree.

Distances are computed where the rows lie (the match/valid kernel on the
card). Every discrete choice — the rng draws, the medoid picks, the
assignment, the rebalance — is host numpy on host copies of those
distances, the reference's code or its moves in its order, so its sums
run in the reference's order and near ties fall the same way.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..obs import trace as _trace
from . import distance as dist
from . import nj as nj_mod
from . import treeio


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    sample_frac: float = 0.10
    min_sample: int = 8
    target_cluster: int = 64       # desired leaves per cluster
    balance_factor: float = 1.5    # cap = balance_factor * N/k
    seed: int = 0
    correct: bool = True           # JC69 correction


class ClusterPhylogeny(NamedTuple):
    children: np.ndarray
    blen: np.ndarray
    root: int
    assignments: np.ndarray        # (N,) cluster id
    medoids: np.ndarray            # (k,) global row index of each medoid
    n_clusters: int


def farthest_point_medoids(Ds: np.ndarray, k: int) -> np.ndarray:
    """Greedy k-center over a sampled distance matrix (host, O(k * m)).

    ``repro_torch.phylo.tiles.TileContext.greedy_k_center`` is the
    streamed equivalent (same picks, no (m, m) matrix) used by the tiled
    pipeline.
    """
    m = Ds.shape[0]
    first = int(np.argmax(Ds.sum(axis=1)))
    chosen = [first]
    mind = Ds[first].copy()
    for _ in range(1, min(k, m)):
        nxt = int(np.argmax(mind))
        chosen.append(nxt)
        mind = np.minimum(mind, Ds[nxt])
    return np.asarray(chosen)


def rebalance(assign: np.ndarray, xdist: np.ndarray, cap: int) -> np.ndarray:
    """Spill overflow members to the next-nearest cluster with room:
    ``rebalance_rows`` on the rows of the (N, k) distance matrix ``xdist``."""
    own = xdist[np.arange(len(assign)), assign]
    return rebalance_rows(assign, own, cap, xdist.shape[1],
                          lambda idx: np.argsort(xdist[idx], axis=1))


def rebalance_rows(assign: np.ndarray, own_dist: np.ndarray, cap: int,
                   k: int, pref_rows, step: int = 128) -> np.ndarray:
    """Spill overflow members to the next-nearest cluster with room, with
    no (N, k) distance matrix: ``own_dist[i]`` is row i's distance to its
    assigned medoid and ``pref_rows(idx)`` returns ``np.argsort`` of the
    (len(idx), k) distance rows of the rows ``idx``.

    The reference's moves (``repro.core.cluster.rebalance``): a cluster
    above the cap only loses members and one at or below it never rises
    above, so the rows that move are, in each cluster above the cap, as
    many of its members as it has too many, farthest from their medoid
    first (the order of the reference's loop). Only their rows are
    sorted, ``pref_rows`` called on ``step`` of them at a time in loop
    order. Each of them finds room, since ``cap * k > N``
    (cap = ceil(1.5 N / k)).
    """
    assign = assign.copy()
    order = np.argsort(own_dist)[::-1]                          # worst first
    counts = np.bincount(assign, minlength=k)
    excess = np.maximum(counts - cap, 0)
    movers = []
    for i in order:
        if excess[assign[i]] > 0:
            excess[assign[i]] -= 1
            movers.append(i)
    for b0 in range(0, len(movers), step):
        idx = np.asarray(movers[b0:b0 + step])
        for i, pref in zip(idx, pref_rows(idx)):
            c = assign[i]
            for alt in pref:
                if alt != c and counts[alt] < cap:
                    counts[c] -= 1
                    counts[alt] += 1
                    assign[i] = alt
                    break
    return assign


def take(rows: torch.Tensor, idx) -> torch.Tensor:
    """``rows[idx]`` for a host index array, gathered on the rows' device."""
    return rows[torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                                device=rows.device)]


def host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def cluster_phylogeny(msa: torch.Tensor, *, gap_code: int, n_chars: int,
                      cfg: ClusterConfig = ClusterConfig()
                      ) -> ClusterPhylogeny:
    """``msa``: (N, L) int8 rows; distances are computed on its device."""
    N = msa.shape[0]
    rng = np.random.default_rng(cfg.seed)
    kw = dict(gap_code=gap_code, n_chars=n_chars, correct=cfg.correct)

    if N <= max(cfg.target_cluster, cfg.min_sample) * 2:
        # small problem: one monolithic NJ
        D = dist.distance_matrix(msa, **kw)
        children, blen, root = nj_mod.host_tree(nj_mod.neighbor_joining(D, N))
        return ClusterPhylogeny(children, blen, root, np.zeros(N, np.int32),
                                np.arange(min(1, N)), 1)

    # (1)-(2): sample + medoids
    with _trace.span("tree.medoids"):
        m = max(cfg.min_sample, int(N * cfg.sample_frac))
        sample = np.sort(rng.choice(N, size=min(m, N), replace=False))
        Ds = host(dist.distance_matrix(take(msa, sample), **kw))
        k = max(2, int(np.ceil(N / cfg.target_cluster)))
        med_local = farthest_point_medoids(Ds, k)
        del Ds
        medoids = sample[med_local]
        k = len(medoids)

    # (3)-(4): assign all sequences to the nearest medoid, then cap + spill
    with _trace.span("tree.assign"):
        xdist = host(dist.cross_distance(msa, take(msa, medoids), **kw))
        assign = np.argmin(xdist, axis=1)
        cap = max(3, int(np.ceil(cfg.balance_factor * N / k)))
        assign = rebalance(assign, xdist, cap)
        del xdist

    # (5): per-cluster NJ, batched over padded matrices counted in one launch
    with _trace.span("tree.cluster_nj"):
        members = [np.flatnonzero(assign == c) for c in range(k)]
        cap_sz = max(max(len(mm) for mm in members), 3)
        sizes = np.asarray([max(len(mm), 1) for mm in members], np.int32)
        Dpad = dist.distance_groups(
            msa, dist.group_index(members, cap_sz, msa.device), **kw)
        trees = nj_mod.nj_batch(Dpad, sizes)
        del Dpad
        children_b, blen_b = host(trees.children), host(trees.blen)
        cluster_trees = [(children_b[c], blen_b[c], 2 * int(sizes[c]) - 2,
                          int(sizes[c])) for c in range(k)]

    # (6): skeleton over medoids + stitch
    with _trace.span("tree.stitch"):
        Dm = dist.distance_matrix(take(msa, medoids), **kw)
        skel_ch, skel_bl, skel_root = nj_mod.host_tree(
            nj_mod.neighbor_joining(Dm, k))
        members_nonempty = [mm if len(mm) else np.asarray([medoids[c]])
                            for c, mm in enumerate(members)]
        children, blen, root = treeio.stitch_cluster_trees(
            skel_ch, skel_bl, skel_root, cluster_trees, members_nonempty)
    return ClusterPhylogeny(children, blen, root, assign.astype(np.int32),
                            medoids, k)
