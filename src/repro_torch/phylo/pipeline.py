"""HPTree pipeline over distance tiles (paper Fig. 4 at scale).

Mirrors ``core.cluster.cluster_phylogeny`` stage for stage but never
materializes the (N, N) matrix — nor even the (m, m) sketch-sample matrix
that is the dense path's own cliff at ultra-large N:

  (1) sketch sample       host rng, same draws as the dense path
  (2) medoid selection    streamed greedy k-center (``TileContext``)
  (3) assignment          row-block strips against the k medoid rows,
                          keeping each row's nearest medoid and distance
  (4) rebalance           host overflow spill
                          (``core.cluster.rebalance_rows``, the distance
                          rows recomputed for the rows that move only)
  (5) per-cluster NJ      ``nj_batch`` over cluster chunks sized so the
                          padded matrices fit one tile row-block strip,
                          each chunk's matrices counted in one launch
                          (``TileContext.squares``)
  (6) skeleton + stitch   k x k NJ + ``treeio.stitch_cluster_trees``

Resident distance storage stays <= one (row_block, N) strip throughout,
tracked by the ``TileAccountant``. The reference holds the (N, k)
assignment matrix through the rebalance, which breaks that bound once
k > row_block (N > 8,192 at the defaults); the port keeps (N,) vectors
instead. A chunk of per-cluster matrices is counted once, as the
padded (chunk, cap, cap) float32 stack it is on the device (the
reference counts a host stack plus one transient sub-matrix). Two ways
remain to exceed the bound: a single cluster whose padded matrix is more
than a strip (cap^2 > row_block * N, with cap ~ 1.5 * target_cluster,
so N < ~72 at the defaults), and the
(k, k) skeleton matrix above one strip (k^2 > row_block * N, N > ~524,000
at the defaults). Given the same ``ClusterConfig`` the result is
bit-identical to the dense cluster path: the counts are exact integers,
every tile equals the corresponding dense sub-block, and ``nj_batch`` sums
each row in one fixed order whatever its batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import cluster as cluster_mod
from ..core import nj as nj_mod
from ..core import treeio
from ..obs import trace as _trace
from .tiles import TileContext


def tiled_phylogeny(msa, *, tiles: TileContext,
                    cfg: cluster_mod.ClusterConfig = cluster_mod.ClusterConfig()
                    ) -> cluster_mod.ClusterPhylogeny:
    """HPTree cluster-merge phylogeny with tiled, streamed distance stages.

    ``msa``: (N, L) int8 aligned rows (moved to the tiles' device once);
    ``tiles`` carries alphabet, tile geometry, device and the accountant.
    Returns the same ``ClusterPhylogeny`` as
    ``core.cluster.cluster_phylogeny``.
    """
    msa = tiles.rows(msa)
    N = msa.shape[0]
    acct = tiles.accountant
    strip_bytes = tiles.row_block * N * 4
    rng = np.random.default_rng(cfg.seed)
    take = cluster_mod.take

    # (1)-(2): sketch sample + streamed medoid selection
    with _trace.span("tree.medoids"):
        m = max(cfg.min_sample, int(N * cfg.sample_frac))
        sample = np.sort(rng.choice(N, size=min(m, N), replace=False))
        k = max(2, int(np.ceil(N / cfg.target_cluster)))
        med_local = tiles.greedy_k_center(take(msa, sample), k)
        medoids = sample[med_local]
        k = len(medoids)

    # (3)-(4): assignment, one row-block strip at a time, then cap + spill
    # with the distance rows of only the rows that move
    with _trace.span("tree.assign"):
        anchors = take(msa, medoids)
        assign, own = tiles.nearest_assign(msa, anchors)
        cap = max(3, int(np.ceil(cfg.balance_factor * N / k)))
        assign = cluster_mod.rebalance_rows(
            assign, own, cap, k,
            lambda idx: tiles.sorted_rows(msa, anchors, idx),
            step=tiles.row_block)

    # (5): per-cluster NJ, batched in chunks that fit one strip; a chunk's
    # padded matrices are one kernel launch and stay on the device
    with _trace.span("tree.cluster_nj"):
        members = [np.flatnonzero(assign == c) for c in range(k)]
        cap_sz = max(max(len(mm) for mm in members), 3)
        per = cap_sz * cap_sz * 4
        chunk = max(1, strip_bytes // per)   # one chunk's matrices <= a strip
        cluster_trees = []
        for c0 in range(0, k, chunk):
            cs = members[c0:c0 + chunk]
            sizes = np.asarray([max(len(mm), 1) for mm in cs], np.int32)
            nbytes = acct.alloc(len(cs) * per)
            trees = nj_mod.nj_batch(tiles.squares(msa, cs, cap_sz), sizes)
            acct.free(nbytes)
            children_b = trees.children.cpu().numpy()
            blen_b = trees.blen.cpu().numpy()
            for gi in range(len(sizes)):
                cluster_trees.append((children_b[gi], blen_b[gi],
                                      2 * int(sizes[gi]) - 2, int(sizes[gi])))

    # (6): skeleton over medoids + stitch
    with _trace.span("tree.stitch"):
        Dm = tiles.track(tiles.square(take(msa, medoids)))
        skel_ch, skel_bl, skel_root = nj_mod.host_tree(
            nj_mod.neighbor_joining(torch.from_numpy(Dm).to(msa.device), k))
        tiles.release(Dm)
        members_nonempty = [mm if len(mm) else np.asarray([medoids[c]])
                            for c, mm in enumerate(members)]
        children, blen, root = treeio.stitch_cluster_trees(
            skel_ch, skel_bl, skel_root, cluster_trees, members_nonempty)
    return cluster_mod.ClusterPhylogeny(children, blen, root,
                                        assign.astype(np.int32), medoids, k)
