"""MLRefiner: maximum-likelihood tree refinement over the pruning levels.

The reference's ``repro.phylo.ml`` on PyTorch:

1. **Branch lengths by autodiff** — all 2N-2 lengths (plus the model's
   free parameters) optimized jointly by ``torch.optim.Adam`` (optax's
   defaults) through ``core.likelihood.forest_log_likelihood``. Lengths
   live as softplus of an unconstrained vector, and the fit keeps the
   best point of the trajectory on the device, so the result is never
   worse than the input and no step waits for the host.
2. **Topology by NNI** — every internal edge contributes its two
   nearest-neighbor interchanges; all 2(N-2) candidates carry their own
   (children, blen, order) arrays and score as a forest, in chunks sized
   to ``MEMORY_BUDGET`` (the reference's single vmap would hold every
   candidate's partials at once: 33 GB at 1,024 leaves). The best
   strictly-improving swap is applied, branch lengths refit, repeat.
3. **Bootstrap by reweighting** — a nonparametric replicate is a
   multinomial reweighting of the pattern counts, drawn on the host from
   a ``torch.Generator`` seeded from ``(seed, b)``, so a replicate's
   weights do not depend on how replicates are chunked; each replicate
   is a weighted JC69 distance matrix plus one NJ, batched
   (``replicate_trees`` through ``core.nj.nj_batch``). Support for an
   edge is the fraction of replicate trees containing its bipartition.
   The draws are not JAX's ``fold_in`` stream: the same ``seed`` gives
   other replicates, and other supports, than the reference's.

Model selection (``model="auto"``) fits every registry model and picks
the BIC minimizer. Candidate construction and renumbering are host numpy,
the reference's code.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core import distance as dist_mod
from ..core import likelihood as lik
from ..core import nj as nj_mod
from ..core import treeio
from ..device import resolve_device
from ..obs import trace as _trace
from . import models

# device bytes the forest evaluator may hold for one chunk of scored
# trees, and bootstrap replicates for one batch: a tenth of an 80 GB card
MEMORY_BUDGET = 8 << 30


def _inv_softplus(y):
    # the optimizer's positivity clamp: lengths enter as softplus(raw),
    # so the inverse floors at 1e-6
    y = torch.clamp(y, min=1e-6)
    return y + torch.log(-torch.expm1(-y))


def _softplus(x):
    # jax.nn.softplus: torch's F.softplus switches to x above 20
    return torch.logaddexp(x, torch.zeros_like(x))


def _tensor(x, dev, dtype=None):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(dev) if dtype is None else x.to(dev, dtype)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ------------------------------------------------------------------ fitting

def _fit(patterns, weights, children, order, root, blen0, params0, *,
         model: str, steps: int, lr: float, site_chunk: int):
    """Joint branch-length + model-parameter fit; returns the best point
    ``(blen (M, 2), params, logl)`` as tensors on ``patterns``' device.

    Step 0 evaluates the input tree exactly, and the returned point is
    the argmin of the loss over the whole Adam trajectory and its final
    point, tracked with ``torch.where`` on the device. The topology is
    fixed for the whole fit, so on a card one step — forward, backward,
    the best-point update and Adam's — is captured once as a CUDA graph
    (``_captured``) and replayed ``steps`` times: no step waits for the
    host or pays its per-operation launch cost. On the CPU the same step
    runs eagerly.
    """
    dev = patterns.device
    children = _host(children)
    M = children.shape[0]
    sched = lik.level_schedule(children, _host(order), int(root),
                               patterns.shape[0], dev)
    blen0 = _tensor(blen0, dev, torch.float32)
    params0 = _tensor(params0, dev, torch.float32)
    packed = torch.cat([_inv_softplus(blen0).reshape(-1), params0]
                       ).detach().requires_grad_(True)

    def nll(p):
        bl = _softplus(p[:2 * M].reshape(M, 2))
        dec = models.decompose(model, p[2 * M:])
        return -lik.forest_log_likelihood(
            patterns, weights, sched, bl, dec.lam, dec.U, dec.sp, dec.pi,
            site_chunk=site_chunk)[0]

    graphed = dev.type == "cuda"
    opt = torch.optim.Adam([packed], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           capturable=graphed)
    best_nll = torch.full((), float("inf"), device=dev)
    best_p = packed.detach().clone()

    def step():
        opt.zero_grad(set_to_none=True)
        loss = nll(packed)
        loss.backward()
        with torch.no_grad():
            better = loss < best_nll
            best_nll.copy_(torch.where(better, loss, best_nll))
            best_p.copy_(torch.where(better, packed, best_p))
        opt.step()

    if graphed and steps > 0:
        graph = _captured(step, packed, opt, best_nll, best_p)
        for _ in range(steps):
            graph.replay()
        del graph
    else:
        for _ in range(steps):
            step()
    with torch.no_grad():
        final = nll(packed)
        better = final < best_nll
        best_nll = torch.where(better, final, best_nll)
        best_p = torch.where(better, packed, best_p)
        return (_softplus(best_p[:2 * M].reshape(M, 2)), best_p[2 * M:],
                -best_nll)


def _captured(step, packed, opt, best_nll, best_p):
    """``step`` as a CUDA graph, the fit's state reset to its start.

    One eager warm-up step on a side stream creates the gradient, the
    optimizer's state and the library workspaces (the PyTorch guide for
    whole-network capture); the capture records one step; then the
    parameters, the best point and Adam's moments and step count go back
    to where the fit starts, so the first replay is the first step.
    """
    start = packed.detach().clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    opt.zero_grad(set_to_none=True)
    with torch.cuda.graph(graph):
        step()
    with torch.no_grad():
        packed.copy_(start)
        best_nll.fill_(float("inf"))
        best_p.copy_(start)
        for state in opt.state.values():
            for key in ("step", "exp_avg", "exp_avg_sq"):
                state[key].zero_()
    return graph


def scoring_bytes(n_leaves: int, n_nodes: int, sites: int, trees: int,
                  n_patterns: int) -> int:
    """Device bytes one ``forest_log_likelihood`` call over ``trees``
    trees and ``sites`` patterns at a time holds at its peak (no
    autograd), from what it allocates:

    * per tree and site: the partials buffer and its scales (20 bytes for
      each internal node), the widest level's gathered children and their
      product (64 bytes for each of its at most N/2 nodes: nodes of one
      height have disjoint subtrees of two or more leaves), the root's
      site likelihoods (48 bytes);
    * per tree: the branches' transition matrices with their build
      temporaries, lengths and level indices (600 bytes for each node);
    * once: the tip partials, their build and the next chunk's (70 bytes
      for each leaf and site), and the padded codes (N x P bytes).
    """
    N, I, p = n_leaves, n_nodes - n_leaves, sites
    per_tree = p * (20 * I + 32 * N + 48) + 600 * n_nodes
    return trees * per_tree + 70 * N * p + N * n_patterns


def scoring_plan(n_leaves: int, n_nodes: int, n_patterns: int,
                 site_chunk: int, budget: int = MEMORY_BUDGET):
    """``(trees per forest call, site chunk)`` for scoring under
    ``budget`` bytes, as ``scoring_bytes`` counts them. All sites at once
    when one tree fits the budget (scoring records no autograd, so
    chunking sites would only add launches), else ``site_chunk`` sites
    at a time."""
    def fits(trees, sites):
        return scoring_bytes(n_leaves, n_nodes, sites, trees,
                             n_patterns) <= budget
    if site_chunk <= 0 or fits(1, n_patterns):
        site_chunk, p = 0, n_patterns
    else:
        p = min(site_chunk, n_patterns)
    one = scoring_bytes(n_leaves, n_nodes, p, 1, n_patterns)
    per_tree = one - scoring_bytes(n_leaves, n_nodes, p, 0, n_patterns)
    return max(1, 1 + (budget - one) // per_tree), site_chunk


def score_trees(patterns, weights, children_k, blen_k, order_k, root, dec,
                *, site_chunk: int, budget: int = MEMORY_BUDGET):
    """(T,) logL of a stack of trees, in chunks of ``scoring_plan``'s size.

    ``children_k``/``order_k`` host arrays (T, M, 2) / (T, M-N),
    ``blen_k`` (T, M, 2); ``dec`` a ``models.Decomposition`` shared by
    every tree or with a leading T axis (one model per tree). Returns a
    host float32 array.
    """
    dev = patterns.device
    children_k, order_k = _host(children_k), _host(order_k)
    T, M, _ = children_k.shape
    N, P = patterns.shape
    per, site_chunk = scoring_plan(N, M, P, site_chunk, budget)
    blen_k = _tensor(blen_k, dev, torch.float32)
    shared = dec.lam.dim() == 1
    out = []
    with torch.no_grad():
        for a in range(0, T, per):
            b = min(a + per, T)
            sched = lik.level_schedule(children_k[a:b], order_k[a:b],
                                       np.broadcast_to(root, (b - a,)), N,
                                       dev)
            lam, U, sp, pi = (dec if shared else
                              (x[a:b] for x in dec))
            out.append(lik.forest_log_likelihood(
                patterns, weights, sched, blen_k[a:b], lam, U, sp, pi,
                site_chunk=site_chunk))
    if not out:
        return np.zeros(0, np.float32)
    return torch.cat(out).cpu().numpy()


def _score_candidates(patterns, weights, children_k, blen_k, order_k, root,
                      params, *, model: str, site_chunk: int,
                      budget: int = MEMORY_BUDGET):
    """logL of every NNI candidate under one model (host float32 array)."""
    dec = models.decompose(model, _tensor(params, patterns.device,
                                          torch.float32))
    return score_trees(patterns, weights, children_k, blen_k, order_k, root,
                       dec, site_chunk=site_chunk, budget=budget)


# ---------------------------------------------------------------- topology

def nni_candidates(children, blen, order, n_leaves: int):
    """All 2(N-2) nearest-neighbor interchanges around internal edges.

    For each edge (p, c) with c internal — p's other child d, c's
    children a, b — the two candidates exchange d with a and with b; the
    moved subtree keeps its pendant branch length. Each candidate carries
    its own processing ``order``: the current order with c moved to just
    before p (d precedes p in any topological order, so the result is
    again topological without renumbering a single node).

    Returns stacked (K, M, 2) children/blen and (K, M-N) orders, all
    numpy (the reference's host code).
    """
    children = np.asarray(children)
    blen = np.asarray(blen)
    order = [int(n) for n in order]
    out_ch, out_bl, out_od = [], [], []
    for p in order:
        for ci in range(2):
            c = int(children[p, ci])
            if c < n_leaves:
                continue                      # edge must join two internals
            d = int(children[p, 1 - ci])
            base = [n for n in order if n != c]
            base.insert(base.index(p), c)
            for si in range(2):               # swap d with children[c, si]
                ch2 = children.copy()
                bl2 = blen.copy()
                swapped = int(children[c, si])
                ch2[p, 1 - ci] = swapped
                bl2[p, 1 - ci] = blen[c, si]
                ch2[c, si] = d
                bl2[c, si] = blen[p, 1 - ci]
                out_ch.append(ch2)
                out_bl.append(bl2)
                out_od.append(base)
    if not out_ch:
        return (np.zeros((0,) + children.shape, np.int32),
                np.zeros((0,) + blen.shape, np.float32),
                np.zeros((0, len(order)), np.int32))
    return (np.stack(out_ch).astype(np.int32),
            np.stack(out_bl).astype(np.float32),
            np.asarray(out_od, np.int32))


def renumber_topological(children, blen, root, order, n_leaves: int):
    """Relabel internal nodes so array index order is topological again:
    internal node ``order[i]`` becomes ``N + i``."""
    children = np.asarray(children)
    blen = np.asarray(blen)
    new = np.arange(children.shape[0])
    for i, node in enumerate(order):
        new[int(node)] = n_leaves + i
    ch2 = np.full_like(children, -1)
    bl2 = np.zeros_like(blen)
    for node in range(children.shape[0]):
        if children[node, 0] >= 0:
            ch2[new[node]] = new[children[node]]
            bl2[new[node]] = blen[node]
    return ch2.astype(np.int32), bl2.astype(np.float32), int(new[int(root)])


# --------------------------------------------------------------- bootstrap

def _replicate_seed(seed: int, b: int) -> int:
    return int(np.random.SeedSequence((int(seed), int(b))).generate_state(
        1, np.uint64)[0])


def replicate_weights(seed: int, weights, *, n_replicates: int,
                      n_sites: int, start: int = 0) -> torch.Tensor:
    """(B, P) multinomial bootstrap reweightings of the pattern counts
    (host float32 tensor), replicates ``start .. start + B - 1``.

    Replicate b draws ``n_sites`` patterns with probability proportional
    to ``weights`` from its own CPU ``torch.Generator`` seeded from
    ``(seed, b)``: its weights do not depend on the chunk it is drawn in,
    nor on the device the trees are built on.
    """
    w = np.asarray(_host(weights), np.float64)
    probs = torch.from_numpy(w / w.sum())
    out = torch.zeros((n_replicates, w.shape[0]), dtype=torch.float32)
    for i in range(n_replicates):
        g = torch.Generator().manual_seed(_replicate_seed(seed, start + i))
        idx = torch.multinomial(probs, n_sites, replacement=True,
                                generator=g)
        out[i] = torch.bincount(idx, minlength=w.shape[0]).to(torch.float32)
    return out


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block, the
    caller's setting restored after. cuBLAS is deterministic only under a
    fixed workspace configuration: ``CUBLAS_WORKSPACE_CONFIG`` is set
    here unless the caller set it (``tree_run`` sets it before any work
    on the card)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


@contextlib.contextmanager
def _exact_float32():
    """float32 products at full precision: TF32 would round the weighted
    counts."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def weighted_distance_matrix(patterns, w, *, gap_code: int, n_chars: int,
                             correct: bool = True):
    """JC69 distance matrices under per-pattern weights ``w`` (P,) or a
    batch (B, P): (N, N) or (B, N, N) on ``patterns``' device.

    With unit weights this is ``core.distance.distance_matrix``; under
    bootstrap weights the match/valid counts are weighted sums of one-hot
    products, still exact integers in float32.
    """
    single = w.dim() == 1
    W = w[None] if single else w
    codes = patterns.to(torch.int64)
    valid = (codes != gap_code) & (codes < n_chars)
    oh = ((codes[:, :, None] == torch.arange(n_chars, device=codes.device))
          & valid[:, :, None]).to(torch.float32)                # (N, P, C)
    N = oh.shape[0]
    vf = valid.to(torch.float32)
    with _exact_float32():
        a = (oh[None] * W[:, None, :, None]).reshape(W.shape[0], N, -1)
        match = a @ oh.reshape(N, -1).T
        valid_ct = (vf[None] * W[:, None, :]) @ vf.T
    d = dist_mod.counts_to_distance(match, valid_ct, correct=correct)
    d = 0.5 * (d + d.transpose(-1, -2))
    d = d * (1.0 - torch.eye(N, device=d.device))
    return d[0] if single else d


def replicate_bytes(n_leaves: int, n_patterns: int, n_chars: int,
                    replicates: int) -> int:
    """Device bytes one ``replicate_trees`` batch holds at its peak: per
    replicate the weighted one-hots and weighted valid masks (4 N P (C+1)
    bytes) and 48 bytes for each of its N x N entries — the counts, the
    distance temporaries and, in ``nj_batch``, its matrix, pair mask,
    row-sum folds, Q and masked Q alive across a step; once, the codes,
    masks and one-hots (N P (13 + 6C) bytes)."""
    N, P, C = n_leaves, n_patterns, n_chars
    return replicates * (4 * N * P * (C + 1) + 48 * N * N) \
        + N * P * (13 + 6 * C)


def replicates_per_chunk(n_leaves: int, n_patterns: int, n_chars: int,
                         budget: int = MEMORY_BUDGET) -> int:
    """Replicates one ``replicate_trees`` batch may hold under ``budget``,
    as ``replicate_bytes`` counts them."""
    fixed = replicate_bytes(n_leaves, n_patterns, n_chars, 0)
    per = replicate_bytes(n_leaves, n_patterns, n_chars, 1) - fixed
    return max(1, (budget - fixed) // per)


def replicate_trees(patterns, W, *, gap_code: int, n_chars: int,
                    correct: bool = True, budget: int = MEMORY_BUDGET):
    """One NJ tree per bootstrap reweighting: host (B, 2N-1, 2) children
    and blen. Replicates run in batches of ``replicates_per_chunk``, each
    one weighted distance product and one ``nj_batch``."""
    dev = patterns.device
    W = _tensor(W, dev, torch.float32)
    n, P = patterns.shape
    per = replicates_per_chunk(n, P, n_chars, budget)
    ch_out, bl_out = [], []
    for a in range(0, W.shape[0], per):
        D = weighted_distance_matrix(patterns, W[a:a + per],
                                     gap_code=gap_code, n_chars=n_chars,
                                     correct=correct)
        t = nj_mod.nj_batch(D, [n] * D.shape[0])
        ch_out.append(t.children.cpu().numpy())
        bl_out.append(t.blen.cpu().numpy())
    if not ch_out:
        return (np.zeros((0, 2 * n - 1, 2), np.int32),
                np.zeros((0, 2 * n - 1, 2), np.float32))
    return np.concatenate(ch_out), np.concatenate(bl_out)


def split_support(children, root, n_leaves: int, rep_children) -> np.ndarray:
    """Per-node bootstrap support for the final tree's internal edges.

    support[node] = fraction of replicate trees whose bipartition set
    contains the split induced by the edge above ``node``; NaN for
    leaves, the root, and trivial splits.
    """
    from collections import Counter

    children = np.asarray(children)
    rep_children = np.asarray(rep_children)
    B = rep_children.shape[0]
    tally: Counter = Counter()
    rep_root = 2 * n_leaves - 2
    for b in range(B):
        tally.update(treeio.bipartitions(rep_children[b], rep_root, n_leaves))
    ml_sets = treeio.leaf_sets(children, int(root), n_leaves)
    all_leaves = frozenset(range(n_leaves))
    support = np.full(children.shape[0], np.nan, np.float32)
    for node, s in ml_sets.items():
        if node == int(root) or children[node][0] < 0:
            continue
        if not (1 < len(s) < n_leaves - 1):
            continue
        support[node] = tally[treeio.canonical_split(s, all_leaves)] / B
    return support


# ---------------------------------------------------------------- refiner

class MLResult(NamedTuple):
    children: np.ndarray      # (2N-1, 2) int32, index-topological again
    blen: np.ndarray          # (2N-1, 2) float32 optimized lengths
    root: int
    model: str                # the fitted (or BIC-selected) model
    params: np.ndarray        # its unconstrained parameter vector
    logl_init: float          # input tree under JC69 (what --tree-ll sees)
    logl_final: float         # refined tree under the selected model
    bic: Dict[str, float]     # per-candidate-model BIC (1 entry unless auto)
    n_nni: int                # accepted interchanges


def _patterns(msa, patterns, weights, dev):
    """Host (patterns, weights) — compressed here unless given — and
    their device tensors."""
    if patterns is None:
        patterns, weights = lik.compress_patterns(msa)
    patterns, weights = np.asarray(patterns), np.asarray(weights)
    return (patterns, weights, _tensor(patterns, dev),
            _tensor(weights, dev, torch.float32))


@dataclasses.dataclass(frozen=True)
class MLRefiner:
    """Configured ML refinement on ``device``; nucleotide alignments only
    (4 states)."""

    gap_code: int
    n_chars: int = 5             # distance-alphabet size (bootstrap NJ)
    correct: bool = True         # JC69 distance correction (bootstrap NJ)
    model: str = "auto"          # auto = BIC over the registry
    steps: int = 150             # adam steps per fit
    lr: float = 0.05
    nni_rounds: int = 8          # max accepted-interchange rounds
    min_gain: float = 1e-2       # logL gain an NNI must clear
    site_chunk: int = 2048       # checkpoint granularity (0 = off)
    seed: int = 0
    mesh: Optional[object] = None    # a dist.sharding.Mesh (bootstrap)
    device: str = "cuda"

    def __post_init__(self):
        if self.model != "auto":
            models.validate(self.model)

    # ------------------------------------------------------------- refine

    def refine(self, msa, children, blen, root, *,
               patterns=None, weights=None) -> MLResult:
        """Optimize branch lengths + model, hill-climb topology by NNI.

        ``children``/``blen`` must be index-topological; the result is
        renumbered back to that convention. ``patterns``/``weights``
        accept a precomputed ``compress_patterns(msa)``. On a mesh every
        rank refines (a host stage of the reference) under deterministic
        algorithms, so every rank computes the same tree.
        """
        with (_deterministic() if self.mesh is not None
              else contextlib.nullcontext()):
            return self._refine(msa, children, blen, root,
                                patterns=patterns, weights=weights)

    def _refine(self, msa, children, blen, root, *, patterns,
                weights) -> MLResult:
        dev = resolve_device(self.device)
        n = msa.shape[0]
        patterns_np, weights_np, patterns, weights = _patterns(
            msa, patterns, weights, dev)
        n_sites = float(weights_np.sum())
        children = np.asarray(children, np.int32)
        # NJ emits slightly negative lengths; evaluate (and start the
        # fit) from the zero-floored tree
        blen = np.maximum(np.asarray(blen, np.float32), 0.0)
        root = int(root)
        M = children.shape[0]
        order = np.arange(n, M, dtype=np.int32)
        fit_kw = dict(steps=self.steps, lr=self.lr,
                      site_chunk=self.site_chunk)

        dec0 = models.decompose("jc69", torch.zeros(0, device=dev))
        with torch.no_grad():
            logl_init = float(lik.pruning_log_likelihood(
                patterns, weights, children, torch.from_numpy(blen), order,
                root, dec0.lam, dec0.U, dec0.sp, dec0.pi,
                site_chunk=self.site_chunk))

        freqs = models.empirical_freqs(patterns_np, weights_np)
        candidates = models.MODELS if self.model == "auto" else (self.model,)
        fits, bics = {}, {}
        for m in candidates:
            with _trace.span("ml.fit", model=m):
                bl_m, pr_m, ll_m = _fit(
                    patterns, weights, children, order, root, blen,
                    models.init_params(m, freqs), model=m, **fit_kw)
                fits[m] = (_host(bl_m), _host(pr_m), float(ll_m))
            bics[m] = models.bic(fits[m][2], m, 2 * n - 2, n_sites)
        model = min(bics, key=bics.get)
        blen, params, logl = fits[model]

        n_nni = 0
        for _ in range(self.nni_rounds):
            ch_k, bl_k, od_k = nni_candidates(children, blen, order, n)
            if ch_k.shape[0] == 0:
                break
            with _trace.span("ml.score", candidates=ch_k.shape[0]):
                lls = _score_candidates(
                    patterns, weights, ch_k, bl_k, od_k, root, params,
                    model=model, site_chunk=self.site_chunk)
            best = int(np.argmax(lls))
            if float(lls[best]) <= logl + self.min_gain:
                break
            children, blen, order = ch_k[best], bl_k[best], od_k[best]
            with _trace.span("ml.fit", model=model):
                bl_j, pr_j, ll_j = _fit(patterns, weights, children, order,
                                        root, blen, params, model=model,
                                        **fit_kw)
                blen, params, logl = _host(bl_j), _host(pr_j), float(ll_j)
            n_nni += 1

        children, blen, root = renumber_topological(children, blen, root,
                                                    order, n)
        return MLResult(children, blen, root, model, np.asarray(params),
                        logl_init, float(logl), bics, n_nni)

    # ---------------------------------------------------------- bootstrap

    def bootstrap(self, msa, children, blen, root, n_replicates: int, *,
                  patterns=None, weights=None) -> np.ndarray:
        """Nonparametric bootstrap support for the tree's internal edges
        (``replicate_weights`` seeded from ``(self.seed, b)``)."""
        dev = resolve_device(self.device)
        _, weights_np, patterns, _ = _patterns(msa, patterns, weights, dev)
        ch_b, _ = self.replicate_trees(patterns, weights_np, n_replicates)
        return split_support(children, root, msa.shape[0], ch_b)

    def replicate_trees(self, patterns, weights_np, n_replicates: int):
        """Host ``(children, blen)`` (B, 2N-1, 2) of the bootstrap
        replicates of the (device) site ``patterns`` and their host counts
        ``weights_np``.

        Replicates split over ``self.mesh``'s data axis when one is set
        (``dist.mapreduce.bootstrap_over_mesh``): each rank draws and
        builds its block of replicates, B padded with all-zero weight
        rows; a replicate's weights and tree do not depend on its block,
        so the trees are the same on every mesh shape."""
        n_sites = int(round(float(weights_np.sum())))
        if self.mesh is None:
            W = replicate_weights(self.seed, weights_np,
                                  n_replicates=n_replicates, n_sites=n_sites)
            return replicate_trees(patterns, W, gap_code=self.gap_code,
                                   n_chars=self.n_chars,
                                   correct=self.correct)
        from ..dist import mapreduce
        from ..dist import sharding as sh
        per = -(-n_replicates // sh.axis_size(self.mesh, "data"))
        b0 = self.mesh.block_index("data") * per
        W = torch.zeros((per, weights_np.shape[0]), dtype=torch.float32)
        mine = max(0, min(per, n_replicates - b0))
        W[:mine] = replicate_weights(self.seed, weights_np,
                                     n_replicates=mine, n_sites=n_sites,
                                     start=b0)
        fn = mapreduce.bootstrap_over_mesh(
            self.mesh, gap_code=self.gap_code, n_chars=self.n_chars,
            correct=self.correct)
        ch_b, bl_b = fn(patterns, W)
        return (mapreduce.unpad_rows(ch_b, n_replicates),
                mapreduce.unpad_rows(bl_b, n_replicates))
