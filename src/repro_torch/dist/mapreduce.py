"""Center-star MSA over a mesh: the paper's Fig. 3 pipeline, one process a
rank.

Spark terms -> mesh terms:

  RDD of sequence shards     this rank's block of query rows
                             (``sharding.shard_rows`` over the data axis)
  broadcast(center, index)   rank 0's center row and k-mer table
                             (``sharding.broadcast``)
  map(1)  align-to-center    ``core.msa.kmer_align_batch`` / an
                             ``AlignEngine`` primitive on the rank's shard
                             (kernel 1, or kernels 3/4 for the banded
                             backends, on the card)
  reduce(1) merge profiles   local columnwise max, then one MAX
                             ``all_reduce`` of the (num_slots,) profile
  map(2)  re-emit rows       ``core.centerstar.build_rows`` per shard,
                             then one ``all_gather`` of the rows

Semantics are the reference's ``repro.dist.mapreduce`` to the byte: the
banded backends take the band's result with no per-pair overflow
fallback (re-aligning would need the full direction matrix the band is
there to avoid), k-mer chain failures re-align through the engine's own
primitive (``fallback="dp"``), and padded rows (length 0) align as empty
queries that add nothing to the profile. Counts of per-pair fallbacks are
not kept across shards (``MSAResult.n_fallback == -1``).

The tree- and search-stage hooks split the same way, each on the port's
single-device function for its shard: ``distance_strip_over_mesh`` and
``nearest_anchor_over_mesh`` (``core.distance.cross_distance``, kernel 2),
``bootstrap_over_mesh`` (``phylo.ml.replicate_trees``),
``treesearch_over_mesh`` (``phylo.treesearch.score_fleet``) and
``search_over_mesh`` (``search.engine.seed_counts_batch``). Each returns
its result whole, on every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import centerstar
from ..obs import metrics as _obs
from ..obs import trace as _trace
from . import sharding as sh

_C_MAP_CALLS = _obs.counter("repro_dist_map_calls_total",
                            "host-side mesh pipeline invocations", ("stage",))


def pad_rows(x, multiple_of: int, fill=0):
    """Pad the leading dim up to a multiple of ``multiple_of``.

    Returns (padded, original_n). For query batches pass ``fill=0`` (a valid
    alphabet code) and pad the matching ``lens`` with 0 so padded rows align
    as empty queries.
    """
    x = np.asarray(x)
    n = x.shape[0]
    rem = (-n) % multiple_of
    if rem == 0:
        return x, n
    pad = np.full((rem,) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad], axis=0), n


def unpad_rows(x, n: int):
    """Drop the rows ``pad_rows`` added."""
    return x[:n]


def shard_padded(x, mesh: sh.Mesh, axis="data", fill=0) -> torch.Tensor:
    """``shard_rows(pad_rows(x, n_shards, fill)[0], mesh, axis)`` for a
    host array or a tensor, padding (and moving) only this rank's
    block."""
    n_shards = sh.axis_size(mesh, axis)
    n = x.shape[0]
    per = -(-n // n_shards)
    b = mesh.block_index(axis)
    blk = x[min(b * per, n):min((b + 1) * per, n)]
    if not isinstance(blk, torch.Tensor):
        blk = torch.from_numpy(np.ascontiguousarray(blk))
    blk = blk.to(mesh.device)
    if blk.shape[0] < per:
        blk = torch.cat([blk, blk.new_full(
            (per - blk.shape[0],) + tuple(blk.shape[1:]), fill)])
    return blk


def _chunked(f, n_chunks: int, *arrs):
    """Run ``f`` over ``n_chunks`` sequential slices of the leading dim and
    concatenate its outputs (a tuple of tensors, or one)."""
    if n_chunks <= 1:
        return f(*arrs)
    per = arrs[0].shape[0] // n_chunks
    outs = [f(*(a[i * per:(i + 1) * per] for a in arrs))
            for i in range(n_chunks)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _pad_cols(x, width: int, fill: int):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]), value=fill) \
        if x.shape[-1] < width else x


def distributed_center_star(mesh: sh.Mesh, *, method: str, sub,
                            gap_code: int, out_len: int, num_slots: int,
                            gap_open: int, gap_extend: int, k: int = 11,
                            stride: int = 1, max_anchors: int = 256,
                            max_seg: int = 64, map_chunks: int = 1,
                            data_axis: str = "data", fallback: str = "dp",
                            local: bool = False, backend: str = "auto",
                            band: int = 64):
    """Build the distributed pipeline for one problem geometry.

    Returns ``fn(Q, lens, center, lc, table)`` (``table`` only for
    ``method='kmer'``) -> ``(rows, G)``: ``Q``/``lens`` are this rank's
    shard (``sharding.shard_rows``), ``rows`` its (shard, out_len) int8
    rows in the merged frame and ``G`` the merged (num_slots,) insert
    profile, equal on every rank.

    ``backend`` picks the map(1) DP primitive as ``AlignEngine`` does (the
    full-DP kernel, or the banded forward kernel for ``banded`` /
    ``banded-pallas``). The banded backends take the band's result as it
    is, with no per-pair overflow fallback. ``fallback='dp'`` re-aligns
    pairs whose k-mer chaining failed through the engine's global
    primitive (the host driver's result when no band overflows);
    ``fallback='none'`` keeps the failed chains' rows.
    """
    if method not in ("kmer", "plain", "sw"):
        raise ValueError(f"unknown method {method!r}")
    from ..align.engine import AlignEngine
    from ..core import msa as msa_mod
    sub = torch.as_tensor(sub, dtype=torch.float32, device=mesh.device)
    engine = AlignEngine(sub, gap_open=gap_open, gap_extend=gap_extend,
                         gap_code=gap_code, backend=backend, band=band,
                         local=local, bucket=False)

    def _map1_dp(Q, lens, center, lc, *, dp_local=local):
        res = engine.batch_fn(local=dp_local)(Q, lens, center, lc)
        return res.a_row, res.b_row

    def _map1_kmer(Q, lens, center, lc, table):
        a_rows, b_rows, ok = msa_mod.kmer_align_batch(
            Q, lens, center, lc, table, sub, k=k, stride=stride,
            max_anchors=max_anchors, max_seg=max_seg, gap_open=gap_open,
            gap_extend=gap_extend, gap_code=gap_code)
        # one width for every chunk: the k-mer buffer or a DP row
        width = max(a_rows.shape[-1], Q.shape[1] + center.shape[0])
        a_rows = _pad_cols(a_rows, width, gap_code)
        b_rows = _pad_cols(b_rows, width, gap_code)
        bad = torch.nonzero(~ok).flatten()
        if fallback == "dp" and len(bad):
            # the kmer assembly is global; its fallback must be too. Only
            # the failed pairs run: the reference aligns every pair and
            # keeps these rows, which are the same
            da, db = _map1_dp(Q[bad], lens[bad], center, lc, dp_local=False)
            a_rows[bad] = _pad_cols(da, width, gap_code)
            b_rows[bad] = _pad_cols(db, width, gap_code)
        return a_rows, b_rows

    def _map1(*operands):
        if method == "kmer":
            Q, lens, center, lc, table = operands
            return _map1_kmer(Q, lens, center, lc, table)
        Q, lens, center, lc = operands
        return _map1_dp(Q, lens, center, lc)

    def fn(Q, lens, center, lc, *table):
        lens = lens.to(torch.int32)
        lc = int(lc)
        a_rows, b_rows = _chunked(
            lambda q, l: _map1(q, l, center, lc, *table), map_chunks, Q,
            lens)
        g = centerstar.gap_profiles(a_rows, b_rows, gap_code=gap_code,
                                    num_slots=num_slots)
        G = sh.all_reduce_max(g.amax(dim=0), mesh)            # reduce(1)
        rows = _chunked(
            lambda a, b: centerstar.build_rows(a, b, G, gap_code=gap_code,
                                               out_len=out_len),
            map_chunks, a_rows, b_rows)
        return rows, G

    return fn


def distance_strip_over_mesh(mesh: sh.Mesh, *, gap_code: int, n_chars: int,
                             correct: bool = True, data_axis: str = "data"):
    """Tree-stage hook: ``fn(rows_blk, S) -> (rb, N_padded)`` distance strip.

    ``S`` is this rank's shard of the whole aligned row set (padded with
    ``pad_rows``), ``rows_blk`` a (row_block, L) block every rank holds.
    Each rank computes ``cross_distance(rows_blk, its shard)`` — a row-block
    x column-block tile — and the strip comes back concatenated over the
    column dim on every rank. ``repro_torch.phylo.tiles.TileContext``
    streams these strips so no rank holds more than one.
    """
    from ..core import distance as dist_mod

    def fn(blk, S):
        tile = dist_mod.cross_distance(blk, S, gap_code=gap_code,
                                       n_chars=n_chars, correct=correct)
        return sh.gather_rows(tile, mesh, data_axis, dim=1)

    return fn


def nearest_anchor_over_mesh(mesh: sh.Mesh, *, gap_code: int, n_chars: int,
                             correct: bool = True, data_axis: str = "data"):
    """Tree-stage hook: ``fn(S, anchors) -> (N_padded, k)`` distances.

    ``S`` is this rank's shard of the row set, ``anchors`` the k medoid
    rows every rank holds: each rank computes its rows' distances to every
    medoid (the transpose of ``distance_strip_over_mesh``'s tiling: k << N,
    so sharding the long axis balances), gathered over the row dim.
    """
    from ..core import distance as dist_mod

    def fn(S, A):
        d = dist_mod.cross_distance(S, A, gap_code=gap_code,
                                    n_chars=n_chars, correct=correct)
        return sh.gather_rows(d, mesh, data_axis, dim=0)

    return fn


def bootstrap_over_mesh(mesh: sh.Mesh, *, gap_code: int, n_chars: int,
                        correct: bool = True, data_axis: str = "data"):
    """Tree-stage hook: ML bootstrap replicates split over the mesh.

    Returns ``fn(patterns, W) -> (children (B, 2N-1, 2), blen)`` host
    arrays. ``W`` is this rank's shard of the (B, P) replicate weights (pad
    B with all-zero rows first: they give saturated-distance throwaway
    trees that ``unpad_rows`` drops); ``patterns`` the compressed site
    patterns on every rank. Each rank runs ``phylo.ml.replicate_trees``
    for its replicates; a replicate's tree does not depend on the others
    in its batch, so the trees are the same on every mesh shape.
    """
    from ..phylo import ml as ml_mod

    def fn(patterns, W):
        ch, bl = ml_mod.replicate_trees(patterns, W, gap_code=gap_code,
                                        n_chars=n_chars, correct=correct)
        ch = sh.gather_rows(torch.from_numpy(ch).to(mesh.device), mesh,
                            data_axis)
        bl = sh.gather_rows(torch.from_numpy(bl).to(mesh.device), mesh,
                            data_axis)
        return ch.cpu().numpy(), bl.cpu().numpy()

    return fn


def treesearch_over_mesh(mesh: sh.Mesh, *, model: str,
                         site_chunk: int = 2048, data_axis: str = "data"):
    """Tree-stage hook: K-start tree-search candidate scoring split over
    the mesh.

    Returns ``fn(patterns, weights, children_k, blen_k, order_k, params_k,
    n_cand) -> (K, C) logL`` (host float32). The candidate blocks
    (``(K, C, 2N-1, 2)`` children/blen, ``(K, C, N-1)`` orders), the
    per-search parameters and ``n_cand`` (each search's real candidates)
    are this rank's shard of the searches (pad K first; a padding search
    has ``n_cand`` 0 and scores ``-inf`` that ``unpad_rows`` drops); the
    site patterns and weights are on every rank. Each rank runs
    ``phylo.treesearch.score_fleet`` for its searches.
    """
    from ..phylo import treesearch as ts_mod

    def fn(patterns, weights, ch_k, bl_k, od_k, pr_k, n_cand):
        lls = ts_mod.score_fleet(patterns, weights, ch_k, bl_k, od_k, pr_k,
                                 model=model, site_chunk=site_chunk,
                                 n_cand=n_cand)
        return sh.gather_rows(torch.from_numpy(lls).to(mesh.device), mesh,
                              data_axis).cpu().numpy()

    return fn


def search_over_mesh(mesh: sh.Mesh, *, k: int, stride: int = 1,
                     max_anchors: int = 32, max_seg: int = 1 << 20,
                     data_axis: str = "data"):
    """Search-stage hook: the seeding prefilter over a sharded DB.

    Returns ``fn(Q, qlens, dblens, tables) -> (B, D_padded) anchor
    counts``. The per-sequence k-mer tables and lengths are this rank's
    shard of the DB (pad D first), the query batch is on every rank: each
    rank chains anchors for every (query, local DB row) pair and the
    counts come back concatenated over the DB dim. Counts are per-pair
    integers, equal on every mesh shape; the rescoring stays a host stage.
    """
    from ..search.engine import seed_counts_batch

    def fn(Q, qlens, dblens, tables):
        counts = seed_counts_batch(Q, qlens, dblens, tables, k=k,
                                   stride=stride, max_anchors=max_anchors,
                                   max_seg=max_seg)
        return sh.gather_rows(counts, mesh, data_axis, dim=1)

    return fn


def center_row(center, lc, G, *, gap_code: int, out_len: int):
    """The broadcast center's own row in the merged frame."""
    return centerstar.center_msa_row(center, lc, G, gap_code=gap_code,
                                     out_len=out_len)


def msa_over_mesh(seqs, cfg, mesh: sh.Mesh, *, data_axis: str = "data",
                  map_chunks: int = 1, out_pad: int = 64):
    """Host driver: ``core.msa.center_star_msa`` semantics over a mesh.

    Every rank runs it: center selection (rank 0's choice, broadcast),
    padding the query count to the shard count, this rank's shard and the
    broadcast center, the distributed pipeline, the rows gathered, the
    center's own row, and the trim to the merged width. ``cfg`` is a
    ``core.msa.MSAConfig``. Returns the same ``core.msa.MSAResult`` on
    every rank (``n_fallback=-1``: per-pair fallbacks are not counted
    across shards).
    """
    from ..core import kmer_index
    from ..core import msa as msa_mod
    from ..device import sync

    dev = mesh.device
    alpha = cfg.alpha()
    gap = alpha.gap_code
    S, lens = msa_mod.encode_for_msa(seqs, cfg)
    S, lens = np.asarray(S), np.asarray(lens)
    N, Lmax = S.shape
    if N < 2:
        return msa_mod.MSAResult(S, 0, 0, Lmax, "first")
    with _trace.span("center", n=int(N), mode=cfg.center, dist=True):
        cidx, center_mode = msa_mod._select_center(
            torch.from_numpy(S).to(dev),
            torch.from_numpy(lens).to(dev).to(torch.int32), cfg)
        cidx, center_mode = sh.broadcast_object((int(cidx), center_mode),
                                                mesh)
    lc = int(lens[cidx])
    others = np.array([i for i in range(N) if i != cidx])
    n_shards = sh.axis_size(mesh, data_axis)
    # the per-shard row count also divides map_chunks
    Q, n_q = pad_rows(S[others], n_shards * map_chunks)
    qlens, _ = pad_rows(lens[others], n_shards * map_chunks)

    out_len = 2 * Lmax + out_pad
    num_slots = int(S.shape[1]) + 1
    _C_MAP_CALLS.labels(stage="msa").inc()
    with _trace.span("map1", n=int(N) - 1, method=cfg.method,
                     backend=cfg.backend, dist=True, n_shards=n_shards,
                     shard_rows=Q.shape[0] // n_shards,
                     map_chunks=map_chunks) as sp:
        fn = distributed_center_star(
            mesh, method=cfg.method, sub=cfg.matrix(dev), gap_code=gap,
            out_len=out_len, num_slots=num_slots, gap_open=cfg.gap_open,
            gap_extend=cfg.gap_extend, k=cfg.k, stride=cfg.stride,
            max_anchors=cfg.max_anchors, max_seg=cfg.max_seg,
            map_chunks=map_chunks, data_axis=data_axis, local=cfg.local,
            backend=cfg.backend, band=cfg.band)
        center = sh.broadcast(S[cidx], mesh)
        operands = [sh.shard_rows(Q, mesh, data_axis),
                    sh.shard_rows(qlens, mesh, data_axis), center, lc]
        if cfg.method == "kmer":
            operands.append(sh.broadcast(
                kmer_index.build_center_index(center, lc, k=cfg.k), mesh))
        rows, G = fn(*operands)
        if sp is not None:
            sync(dev)

    with _trace.span("assemble", n=int(N), dist=True):
        width = centerstar.msa_width(G, lc)
        if width > out_len:
            raise ValueError(
                f"merged width {width} exceeds out_len {out_len}; rerun "
                f"with a larger out_pad (sequences too diverged for 2*Lmax)")
        rows = sh.gather_rows(rows, mesh, data_axis)
        crow = center_row(center, lc, G, gap_code=gap, out_len=out_len)
        msa = np.full((N, out_len), gap, np.int8)
        msa[others] = unpad_rows(rows.cpu().numpy(), n_q)
        msa[cidx] = crow.cpu().numpy()
    return msa_mod.MSAResult(msa[:, :width], int(cidx), -1, width,
                             center_mode)
