"""Length-bucketed batching for the map(1) align-to-center stage.

Padding every query to the global Lmax makes one 10x-long outlier
dominate the whole shard's DP cost (the DP is O(n·m) per pair in the
padded length n). The dispatcher groups queries into power-of-two
length buckets and runs the backend once per bucket at that width, so a
bucket of short reads never pays the outlier's padding. Power-of-two
widths bound the number of distinct compiled shapes at log2(Lmax) —
the standard trade between shape-churn recompiles and padding waste.

Two planners share the pow2 rounding:

  ``bucket_plan``       1D: queries against one broadcast center
                        (``AlignEngine.align_to_center``)
  ``pair_bucket_plan``  2D: per-pair targets, buckets keyed on the
                        (query width, target width) pair — the
                        batch-entry path ``AlignEngine.align_pairs``
                        uses to coalesce requests from many callers
                        (each with its own center) into one backend
                        call per bucket
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

