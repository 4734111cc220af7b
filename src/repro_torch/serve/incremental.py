"""Incremental add-to-MSA: align new sequences into an existing alignment.

In the spirit of UPP's phylogeny-aware profile insertion (*Ultra-large
alignments using Phylogeny-aware Profiles*), new sequences are aligned
against the *frozen center* of a previous center-star MSA rather than
re-aligning the whole family. Center-star makes this exact, not an
approximation:

  * the old MSA's center row encodes the merged gap profile ``G_old``
    completely (``G_old[j]`` = gap columns between center chars j-1, j),
  * new pairs are aligned to the center through the *same* map(1) code
    path a full run uses (``core.msa.map1_align_to_center``),
  * the merged profile is ``G_new = max(G_old, profiles(new pairs))``,
    which is exactly what a full realign over old + new pairs computes,
  * old rows move into the wider frame by a per-column shift
    ``cumsum(G_new) - cumsum(G_old)`` — every existing column reappears
    verbatim (new all-gap columns are interleaved, never rewritten), so
    already-aligned members are *bit-identical* to a full realign with
    the same center (pinned by ``tests/test_serve.py``).

Past a drift threshold (relative width growth) the profile-merge frame
is considered stale and the family is fully re-aligned from scratch —
the old sequences are recovered from the MSA rows by stripping gaps.

The stored rows and the frame arithmetic (``center_profile``,
``expand_rows``) are host numpy, as in the reference; the new pairs'
map(1) and their rows run on the engine's device (or ``device``), and so
does a drift realign.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core import centerstar
from ..core.msa import (MSAConfig, center_star_msa, encode_for_msa,
                        map1_align_to_center)
from ..device import resolve_device


class AddResult(NamedTuple):
    msa: np.ndarray        # (N_old + N_new, width) int8, old rows first
    center_idx: int
    width: int
    n_new: int
    realigned: bool        # True = drift exceeded, full realign ran
    n_fallback: int
    growth: float          # (new_width - old_width) / old_width


def center_profile(msa: np.ndarray, center_idx: int, gap: int):
    """Recover (center codes, lc, G_old) from the stored center row."""
    crow = np.asarray(msa[center_idx])
    ischar = crow != gap
    center = crow[ischar]
    lc = int(center.shape[0])
    # slot of each column: number of center chars strictly before it
    slot = np.cumsum(ischar) - ischar
    G_old = np.bincount(slot[~ischar], minlength=lc + 1)[: lc + 1] \
        if (~ischar).any() else np.zeros(lc + 1, np.int64)
    return center.astype(np.int8), lc, G_old.astype(np.int64)


def expand_rows(msa: np.ndarray, center_idx: int, G_old, G_new, gap: int
                ) -> np.ndarray:
    """Re-emit old rows in the wider G_new frame, columns preserved.

    Each old column shifts right by ``(cumsum(G_new) - cumsum(G_old))``
    at its slot; the shift is constant within an insertion block, so
    right-packed blocks stay right-packed — the layout ``build_rows``
    would produce. New columns are all-gap for old members.
    """
    msa = np.asarray(msa)
    crow = msa[center_idx]
    ischar = crow != gap
    slot = np.cumsum(ischar) - ischar                      # (old_w,)
    delta = np.cumsum(G_new) - np.cumsum(G_old)            # (lc+1,) >= 0
    new_cols = np.arange(msa.shape[1]) + delta[slot]
    new_w = msa.shape[1] + int(delta[-1])
    out = np.full((msa.shape[0], new_w), gap, msa.dtype)
    out[:, new_cols] = msa
    return out


def add_to_msa(msa: np.ndarray, center_idx: int,
               new_seqs: Sequence[str], cfg: MSAConfig, *,
               drift_threshold: float = 0.25, engine=None,
               device="cuda") -> AddResult:
    """Insert ``new_seqs`` into an existing center-star MSA.

    ``msa`` is the previous aligned (N, W) int8 block, ``center_idx`` its
    frozen center row. Output rows keep the old order with new members
    appended. ``drift_threshold`` bounds relative width growth; past it
    the whole family (old sequences recovered from the rows) is
    re-aligned with ``cfg``'s own center policy and ``realigned=True``
    is reported. The alignment runs on ``engine``'s device when an
    engine is given, else on ``device`` (raises when CUDA is asked for
    and absent).
    """
    dev = engine.device if engine is not None else resolve_device(device)
    alpha = cfg.alpha()
    gap = alpha.gap_code
    msa = np.asarray(msa)
    n_old, old_w = msa.shape
    center, lc, G_old = center_profile(msa, center_idx, gap)

    Q, qlens = encode_for_msa(list(new_seqs), cfg)
    a_rows, b_rows, n_fallback = map1_align_to_center(
        torch.as_tensor(Q, device=dev),
        torch.as_tensor(qlens, device=dev).to(torch.int32),
        torch.as_tensor(center, device=dev), lc, cfg, engine)

    g = centerstar.gap_profiles(a_rows, b_rows, gap_code=gap,
                                num_slots=lc + 1)
    G_new = np.maximum(G_old,
                       centerstar.merge_profiles(g).cpu().numpy())
    new_w = lc + int(G_new.sum())
    growth = (new_w - old_w) / max(old_w, 1)

    if growth > drift_threshold:
        old_seqs = [alpha.decode(r).replace("-", "") for r in msa]
        res = center_star_msa(old_seqs + list(new_seqs), cfg, device=dev)
        return AddResult(res.msa, res.center_idx, res.width, len(new_seqs),
                         True, res.n_fallback, growth)

    out = np.full((n_old + len(new_seqs), new_w), gap, np.int8)
    out[:n_old] = expand_rows(msa, center_idx, G_old, G_new, gap)
    out[n_old:] = centerstar.build_rows(
        a_rows, b_rows, torch.as_tensor(G_new, device=dev), gap_code=gap,
        out_len=new_w).cpu().numpy()
    return AddResult(out, center_idx, new_w, len(new_seqs), False,
                     int(n_fallback), growth)
