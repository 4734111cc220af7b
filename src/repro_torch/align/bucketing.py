"""Length-bucketed batching for the map(1) align-to-center stage.

Padding every query to the global Lmax makes one 10x-long outlier
dominate the whole shard's DP cost (the DP is O(n·m) per pair in the
padded length n). The dispatcher groups queries into power-of-two
length buckets and runs the backend once per bucket at that width, so a
bucket of short reads never pays the outlier's padding. Power-of-two
widths bound the number of distinct compiled shapes at log2(Lmax) —
the standard trade between shape-churn recompiles and padding waste.

Three planners share the pow2 rounding:

  ``bucket_plan``       1D: queries against one broadcast center
                        (``AlignEngine.align_to_center``)
  ``pair_bucket_plan``  2D: per-pair targets, buckets keyed on the
                        (query width, target width) pair — the
                        batch-entry path ``AlignEngine.align_pairs``
                        uses to coalesce requests from many callers
                        (each with its own center) into one backend
                        call per bucket
  ``band_bucket_plan``  3D: as ``pair_bucket_plan`` but band-aware —
                        buckets additionally keyed on the pow2 band
                        width each pair needs, so pairs with the same W
                        share one banded kernel call
                        (``AlignEngine.align_pairs`` with
                        ``band_policy="adaptive"``)
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _pow2_widths(lens, Lmax: int, min_bucket: int) -> np.ndarray:
    """Per-item pow2 padded width, clamped to [min(min_bucket, Lmax), Lmax]."""
    w = np.maximum(np.asarray(lens).astype(np.int64), 1)
    w = 1 << np.ceil(np.log2(w)).astype(np.int64)      # next pow2 >= len
    return np.clip(w, min(min_bucket, max(Lmax, 1)), max(Lmax, 1))


def bucket_plan(lens, Lmax: int, *, min_bucket: int = 32
                ) -> List[Tuple[int, np.ndarray]]:
    """Group query indices by power-of-two padded width.

    Returns ``[(width, indices), ...]`` sorted by width; widths are
    clamped to ``[min(min_bucket, Lmax), Lmax]`` so a bucket never
    exceeds the physical batch width and tiny buckets don't fragment.
    """
    lens = np.asarray(lens).astype(np.int64)
    if lens.size == 0:
        return []
    w = _pow2_widths(lens, Lmax, min_bucket)
    plan = []
    for width in np.unique(w):
        plan.append((int(width), np.flatnonzero(w == width)))
    return plan


def pair_bucket_plan(qlens, tlens, Lq: int, Lt: int, *, min_bucket: int = 32
                     ) -> List[Tuple[int, int, np.ndarray]]:
    """Group (query, target) pairs by their pow2 (q_width, t_width) bucket.

    Returns ``[(q_width, t_width, indices), ...]`` sorted by (q_width,
    t_width). The bucket count is bounded at log2(Lq) · log2(Lt) distinct
    compiled shapes regardless of how many callers' requests are merged
    into the batch.
    """
    qlens = np.asarray(qlens).astype(np.int64)
    if qlens.size == 0:
        return []
    wq = _pow2_widths(qlens, Lq, min_bucket)
    wt = _pow2_widths(tlens, Lt, min_bucket)
    key = wq * (int(max(Lt, 1)) + 1) + wt          # unique composite key
    plan = []
    for k in np.unique(key):
        idx = np.flatnonzero(key == k)
        plan.append((int(wq[idx[0]]), int(wt[idx[0]]), idx))
    return plan


def band_bucket_plan(qlens, tlens, Lq: int, Lt: int, *, band: int,
                     min_bucket: int = 32
                     ) -> List[Tuple[int, int, int, np.ndarray]]:
    """Band-aware pair buckets: ``[(q_width, t_width, W, indices), ...]``.

    A pair whose length skew ``|la - lb|`` exceeds the band half-width is
    bound to overflow (the band's center line has slope lb/la, so the
    start or end cell falls outside a too-thin band) and would cost a
    full-DP fallback. Each pair therefore gets ``W = next_pow2(|la - lb|
    + band)`` — the engine's band as headroom on top of the skew —
    clamped to ``next_pow2(2·t_width + 2)``, the width at which the band
    covers every column and the result equals the full DP. Pairs sharing
    (q_width, t_width, W) share one kernel call, so the number of calls
    is bounded by pow2 keys, not by distinct skews. The key and its
    order are the reference's, so are the buckets and their order.
    """
    qlens = np.asarray(qlens).astype(np.int64)
    tlens = np.asarray(tlens).astype(np.int64)
    if qlens.size == 0:
        return []

    def _pow2(x):
        return 1 << np.ceil(np.log2(np.maximum(x, 1))).astype(np.int64)

    wq = _pow2_widths(qlens, Lq, min_bucket)
    wt = _pow2_widths(tlens, Lt, min_bucket)
    need = np.abs(qlens - tlens) + max(int(band), 2)
    W = np.minimum(_pow2(need), _pow2(2 * wt + 2))
    key = (wq * (int(max(Lt, 1)) + 1) + wt) * (int(2 * max(Lt, 1)) + 3) + W
    plan = []
    for k in np.unique(key):
        idx = np.flatnonzero(key == k)
        plan.append((int(wq[idx[0]]), int(wt[idx[0]]), int(W[idx[0]]), idx))
    return plan
