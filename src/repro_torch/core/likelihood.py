"""Log-likelihood of an MSA given a tree (Felsenstein pruning).

The paper evaluates phylogeny quality by maximum-likelihood value. Two
entry points, as in the reference:

* ``log_likelihood`` — the JC69 closed-form evaluator over raw MSA
  columns (what ``--tree-ll`` reports): a loop over internal nodes in id
  order (children always have smaller ids than their parent), with
  per-node rescaling against underflow.
* ``pruning_log_likelihood`` — the general reversible-model evaluator
  over compressed site patterns, and ``forest_log_likelihood`` beneath
  it, which scores a stack of trees (one tree for a fit, a chunk of
  NNI/SPR candidates for scoring) in one pass. The reference scans the
  internal nodes one by one; here the host computes each node's height
  from ``order`` (``level_schedule``) and every node of one height, in
  every tree of the stack, is evaluated at once: gathers of the
  children's partials and one batched 4x4 product per level. A tree of
  height H costs H device steps, not one per node. The per-node
  arithmetic is the reference's: ``(l0 @ p0.T) * (l1 @ p1.T)``, the
  max-rescale floored at 1e-30, scales summed from both children.
  Under autograd the partials grow by concatenation, one level at a
  time, so autograd sees no in-place write; without it (candidate
  scoring) each level writes its block of one buffer.

``compress_patterns`` collapses identical alignment columns to (pattern,
count) pairs; logL is a weighted sum over unique patterns and a bootstrap
replicate is a reweighting of the counts.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device


def jc69_transition(t):
    """4x4 JC69 transition matrix for branch length t (expected subs/site).

    Exact at t == 0: ``exp(0) == 1`` makes the off-diagonal exactly zero
    and the diagonal exactly one.
    """
    t = torch.as_tensor(t, dtype=torch.float32)
    e = torch.exp(-4.0 * torch.clamp(t, min=0.0) / 3.0)
    same = 0.25 + 0.75 * e
    diff = 0.25 - 0.25 * e
    return diff[..., None, None] * torch.ones((4, 4), device=t.device) + \
        (same - diff)[..., None, None] * torch.eye(4, device=t.device)


def log_likelihood(msa, children, blen, root, *, gap_code: int):
    """JC69 logL (a 0-d float32 tensor); gap/N columns contribute
    uninformative all-ones partials.

    msa: (N, L) int8 tensor with codes A,C,G,T = 0..3; children (M, 2) and
    blen (M, 2) host arrays or tensors; ``gap_code`` is accepted for the
    reference's signature (every code >= 4 is uninformative).
    """
    N, L = msa.shape
    dev = msa.device
    children = (children.cpu().numpy() if isinstance(children, torch.Tensor)
                else np.asarray(children))
    M = children.shape[0]
    blen = (blen if isinstance(blen, torch.Tensor)
            else torch.from_numpy(np.array(blen, np.float32)))
    P = jc69_transition(blen.to(dev, torch.float32))
    Pt = P.transpose(-1, -2)                              # (M, 2, 4, 4)
    codes = msa.to(torch.int64)
    leaf_part = ((codes[..., None] == torch.arange(4, device=dev))
                 | (codes[..., None] >= 4)).to(torch.float32)  # (N, L, 4)
    parts = torch.zeros((M, L, 4), dtype=torch.float32, device=dev)
    parts[:N] = leaf_part
    scales = torch.zeros((M, L), dtype=torch.float32, device=dev)
    for node in range(N, M):
        c0, c1 = int(children[node, 0]), int(children[node, 1])
        if c0 < 0:
            continue
        part = (parts[c0] @ Pt[node, 0]) * (parts[c1] @ Pt[node, 1])
        m = torch.clamp(part.amax(dim=-1, keepdim=True), min=1e-30)
        parts[node] = part / m
        scales[node] = scales[c0] + scales[c1] + torch.log(m[..., 0])
    site_l = torch.sum(0.25 * parts[int(root)], dim=-1)
    return torch.sum(torch.log(torch.clamp(site_l, min=1e-30))
                     + scales[int(root)])


def compress_patterns(msa):
    """(N, L) alignment -> ``(patterns (N, P) int8, weights (P,) f32)``,
    host numpy: identical columns collapse to one pattern with a
    multiplicity (the reference's ``np.unique`` order)."""
    if isinstance(msa, torch.Tensor):
        msa = msa.cpu().numpy()
    cols, counts = np.unique(np.asarray(msa).T, axis=0, return_counts=True)
    return (np.ascontiguousarray(cols.T).astype(np.int8),
            counts.astype(np.float32))


def _transition_from_decomp(lam, U, sp, t):
    """P(t) = diag(1/sp) U diag(exp(lam t)) U^T diag(sp), batched.

    ``lam``/``sp`` (..., 4), ``U`` (..., 4, 4) and ``t`` (...) broadcast
    together; returns (..., 4, 4). Negative t floors at 0 (identity);
    ``torch.maximum`` splits the gradient at t = 0 as ``jnp.maximum``
    does.
    """
    t = torch.maximum(t, torch.zeros_like(t))
    e = torch.exp(lam * t[..., None])
    inner = (U * e[..., None, :]) @ U.transpose(-1, -2)
    return torch.clamp(inner * (sp[..., None, :] / sp[..., :, None]),
                       min=0.0)


class Level(NamedTuple):
    """One height of a ``LevelSchedule``, n nodes: their children as
    slots into the partials and their branches as indices into the
    flattened (T, M, 2) ``blen``, both (2n,) interleaved — child 0, child
    1 of the first node, then the next node's."""
    kids: torch.Tensor
    branches: torch.Tensor


class LevelSchedule(NamedTuple):
    n_trees: int
    levels: List[Level]
    root_slot: torch.Tensor      # (T,) slot of each tree's root


def level_schedule(children, order, root, n_leaves: int,
                   device) -> LevelSchedule:
    """Host plan for ``forest_log_likelihood`` over a stack of trees.

    ``children`` (T, M, 2) or (M, 2), ``order`` (T, M-N) or (M-N,) — any
    topological processing order per tree — and ``root`` (T,) or a
    scalar; the index tensors go to ``device``. A node's height is one
    more than its higher child's (leaves 0). Slots: leaves 0..N-1 (shared
    by every tree), then the internal nodes of all trees sorted by
    (height, tree, position in ``order``), so each level is one
    contiguous block appended after the levels below it.
    """
    children = np.asarray(children, np.int64)
    order = np.asarray(order, np.int64)
    if children.ndim == 2:
        children, order = children[None], order[None]
    T, M, _ = children.shape
    n = n_leaves
    roots = np.broadcast_to(np.asarray(root, np.int64), (T,))
    ti = np.arange(T)
    height = np.zeros((T, M), np.int64)
    for i in range(order.shape[1]):          # vectorized over the trees
        v = order[:, i]
        c = children[ti, v]
        height[ti, v] = 1 + np.maximum(height[ti, c[:, 0]],
                                       height[ti, c[:, 1]])
    tt = np.repeat(ti, order.shape[1])
    vv = order.reshape(-1)
    hh = height[tt, vv]
    # a stable sort of 16-bit keys is a radix sort
    srt = np.argsort(hh.astype(np.int16) if hh.max(initial=0) < 2**15
                     else hh, kind="stable")
    tt, vv, hh = tt[srt], vv[srt], hh[srt]
    slot = np.broadcast_to(np.arange(M), (T, M)).copy()
    slot[tt, vv] = n + np.arange(len(vv))
    kids = slot[tt[:, None], children[tt, vv]].reshape(-1)
    branches = ((tt * M + vv) * 2)[:, None] + np.arange(2)
    dev = torch.device(device)
    flat = _to_device(np.stack([kids, branches.reshape(-1)]), dev)
    bounds = 2 * (np.flatnonzero(np.diff(hh)) + 1)
    starts = [0, *bounds.tolist()]
    ends = [*bounds.tolist(), 2 * len(hh)]
    levels = [Level(flat[0, a:b], flat[1, a:b]) for a, b in zip(starts, ends)]
    return LevelSchedule(T, levels, _to_device(slot[ti, roots], dev))


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array to ``dev``; to a card from pinned memory, so the copy
    is queued behind the device's work instead of waiting for it."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def leaf_partials(patterns):
    """(N, p) int8 codes -> (N, p, 4) float32 tip partials: one-hot over
    A,C,G,T = 0..3; codes >= 4 (N, gap) give all ones."""
    codes = patterns.to(torch.int64)[..., None]
    return ((codes == torch.arange(4, device=patterns.device))
            | (codes >= 4)).to(torch.float32)


def branch_transitions(sched: LevelSchedule, blen, lam, U, sp):
    """P(t)^T of every branch of every tree, (T * M * 2, 4, 4), in one
    batched evaluation; the model is shared or one per tree (leading T
    axis)."""
    T = sched.n_trees
    t = blen.reshape(T, -1)                                   # (T, 2M)
    if lam.dim() == 2:
        lam, U, sp = lam[:, None], U[:, None], sp[:, None]
    return _transition_from_decomp(lam, U, sp, t).transpose(
        -1, -2).reshape(-1, 4, 4)


def _forest_chunk(sched: LevelSchedule, leaf, w, Pt, pi):
    """(T,) logL of one site chunk: the level loop over ``Pt``, the
    branches' transposed transition matrices."""
    N, p = leaf.shape[:2]
    record = torch.is_grad_enabled()
    if record:
        parts = leaf
        scales = torch.zeros((N, p), dtype=leaf.dtype, device=leaf.device)
    else:
        # no autograd: one buffer, each level written into its block
        slots = N + sum(lev.kids.shape[0] // 2 for lev in sched.levels)
        parts = leaf.new_empty((slots, p, 4))
        parts[:N] = leaf
        scales = leaf.new_zeros((slots, p))
    start = N
    for lev in sched.levels:
        n = lev.kids.shape[0] // 2
        # (l0 @ p0.T) and (l1 @ p1.T) of every node of the level at once
        x = torch.matmul(parts[lev.kids].view(n, 2, p, 4),
                         Pt[lev.branches].view(n, 2, 4, 4))
        part = x[:, 0] * x[:, 1]
        del x
        m = torch.clamp(part.amax(dim=-1, keepdim=True), min=1e-30)
        s = scales[lev.kids].view(n, 2, p)
        sc = s[:, 0] + s[:, 1] + torch.log(m[..., 0])
        if record:
            parts = torch.cat([parts, part / m])
            scales = torch.cat([scales, sc])
        else:
            torch.div(part, m, out=parts[start:start + n])
            scales[start:start + n] = sc
        start += n
        # this level's temporaries go before the next level's are made
        del part, m, s, sc
    pi_t = pi if pi.dim() == 1 else pi[:, None, :]
    site_l = torch.sum(pi_t * parts[sched.root_slot], dim=-1)       # (T, p)
    return torch.sum(w * (torch.log(torch.clamp(site_l, min=1e-30))
                          + scales[sched.root_slot]), dim=-1)


def forest_log_likelihood(patterns, weights, sched: LevelSchedule, blen,
                          lam, U, sp, pi, *, site_chunk: int = 0):
    """(T,) pruning logL of every tree of ``sched`` (``level_schedule``).

    ``patterns`` (N, P) int8 and ``weights`` (P,) on the device; ``blen``
    (T, M, 2) (or (M, 2) for one tree). The model — ``lam``/``sp``/``pi``
    (4,) and ``U`` (4, 4) — is shared, or one per tree with a leading T
    axis (the search fleet scores each search under its own parameters).
    Differentiable in ``blen`` and the model. Each level costs a fixed
    handful of device operations whatever its width: one gather of the
    children's partials, one batched 4x4 product, the rescale, one
    concatenation. ``site_chunk > 0`` evaluates the patterns in chunks,
    each under ``torch.utils.checkpoint`` when autograd records (peak
    backward memory follows the chunk, as the reference's
    ``jax.checkpoint`` map); padded patterns are code 4 with weight 0 and
    add nothing.
    """
    N, P = patterns.shape
    Pt = branch_transitions(sched, blen, lam, U, sp)
    if site_chunk <= 0 or P <= site_chunk:
        return _forest_chunk(sched, leaf_partials(patterns), weights, Pt, pi)
    pad = (-P) % site_chunk
    pat = torch.nn.functional.pad(patterns, (0, pad), value=4)
    w = torch.nn.functional.pad(weights, (0, pad))
    record = torch.is_grad_enabled()
    total = 0.0
    for s in range(0, P + pad, site_chunk):
        leaf = leaf_partials(pat[:, s:s + site_chunk])
        args = (sched, leaf, w[s:s + site_chunk], Pt, pi)
        total = total + (checkpoint(_forest_chunk, *args, use_reentrant=False,
                                    preserve_rng_state=False)
                         if record else _forest_chunk(*args))
    return total


def _on(x, dev, dtype=None):
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return x.to(dev) if dtype is None else x.to(dev, dtype)


def pruning_log_likelihood(patterns, weights, children, blen, order, root,
                           lam, U, sp, pi, *, site_chunk: int = 0):
    """General reversible-model pruning logL of one tree (a 0-d tensor).

    The reference's signature: ``patterns`` (N, P) int8 (codes >= 4 are
    uninformative), ``weights`` (P,), ``children``/``blen`` (M, 2),
    ``order`` (M - N,) any topological order of the internal nodes, the
    model pre-decomposed (``repro_torch.phylo.models.decompose``). Runs on
    ``patterns``' device when it is a tensor, else on ``blen``'s, else on
    ``cuda`` (which raises without a card).
    """
    dev = (patterns.device if isinstance(patterns, torch.Tensor)
           else blen.device if isinstance(blen, torch.Tensor)
           else resolve_device("cuda"))
    patterns = _on(patterns, dev)
    if isinstance(children, torch.Tensor):
        children = children.cpu().numpy()
    if isinstance(order, torch.Tensor):
        order = order.cpu().numpy()
    sched = level_schedule(children, order, int(root), patterns.shape[0],
                           dev)
    return forest_log_likelihood(
        patterns, _on(weights, dev, torch.float32), sched,
        _on(blen, dev, torch.float32), _on(lam, dev), _on(U, dev),
        _on(sp, dev), _on(pi, dev), site_chunk=site_chunk)[0]
