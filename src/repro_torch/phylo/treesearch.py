"""Multi-start ML tree search: a restartable K-start NNI+SPR fleet.

The reference's ``repro.phylo.treesearch`` on PyTorch. ``MLRefiner``
hill-climbs from one NJ start with NNI only; this module runs K
independent searches to the same convergence criterion and keeps the
best:

1. **Start diversity** (``fleet_starts``) — start 0 is the NJ tree,
   start 1 the cluster-medoid skeleton (``core.cluster``), starts 2+ are
   random stepwise-addition trees (numpy ``default_rng((seed, i))``, the
   reference's draws). Every start is normalized to the index-topological
   convention (root = 2N-2) so the whole fleet shares one scalar root.
2. **A wider move set** — each round pools the 2(N-2) NNI candidates
   with bounded-radius SPR candidates (``spr_candidates``). The
   candidates of all K searches score as one forest (``score_fleet``,
   in chunks under ``ml.MEMORY_BUDGET``); each search accepts its best
   strictly-improving candidate and refits branch lengths + model
   parameters via ``ml._fit``, or deactivates.
3. **Restartability** — the fleet state is a fixed-shape dict of host
   arrays checkpointed per round through ``dist.checkpoint.
   CheckpointManager`` (the reference's file layout: a JAX-written fleet
   checkpoint resumes here) and driven by ``dist.fault.ResilientLoop``:
   every step is a deterministic function of the state, so a mid-search
   ``StepFailure`` (or a kill + ``resume=True``) replays to a
   bit-identical final tree. The search runs under
   ``torch.use_deterministic_algorithms`` (``_deterministic``): on a card
   the gradients that scatter through the level gathers would otherwise
   be summed by atomics in a varying order.

Candidate construction is the reference's host numpy code, run on every
rank of a ``mesh``; there the (K, C) candidate block splits over the
data axis by search (``dist.mapreduce.treesearch_over_mesh``, K padded
with searches of no candidates) and the scores are gathered to every
rank. A candidate's score does not depend on the others scored with it,
so mesh and one-process runs are bitwise equal. Only rank 0 writes the
checkpoints. Per-start logL trajectories surface through ``repro_torch.obs``
spans (``tree.search``, ``search.round``) and through
``TreeSearchResult.trajectories``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import cluster as cluster_mod
from ..core import distance as dist_mod
from ..core import likelihood as lik
from ..core import nj as nj_mod
from ..device import resolve_device
from ..obs import metrics as _obs
from ..obs import trace as _trace
from . import models
from .ml import (MEMORY_BUDGET, _deterministic, _fit, _host, _patterns,
                 nni_candidates, renumber_topological, score_trees)

_C_MOVES = _obs.counter("repro_treesearch_moves_total",
                        "accepted tree-search moves", ("kind",))
_C_ROUNDS = _obs.counter("repro_treesearch_rounds_total",
                         "tree-search fleet rounds executed")


# ------------------------------------------------------------------- trees

def topological_order(children, root: int, n_leaves: int) -> np.ndarray:
    """Postorder over internal nodes (children before parents, root last).

    The explicit ``order`` array is what lets a tree whose node ids are
    NOT index-topological still score in one forest evaluation; this
    recomputes it from scratch for an arbitrary rooted binary tree.
    """
    children = np.asarray(children)
    order = []
    stack = [(int(root), False)]
    while stack:
        node, expanded = stack.pop()
        if children[node, 0] < 0:
            continue                              # leaf
        if expanded:
            order.append(node)
        else:
            stack.append((node, True))
            stack.append((int(children[node, 1]), False))
            stack.append((int(children[node, 0]), False))
    return np.asarray(order, np.int32)


def normalize_tree(children, blen, root: int, n_leaves: int):
    """Renumber an arbitrary rooted binary tree to index-topological form.

    Returns ``(children, blen, root)`` with internal node ``i`` stored at
    index ``n_leaves + rank(i)`` in postorder — so root = 2N-2 and the
    processing order is simply ``arange(N, 2N-1)``.
    """
    order = topological_order(children, root, n_leaves)
    return renumber_topological(children, blen, root, order, n_leaves)


def random_addition_tree(n_leaves: int, rng, init_blen: float = 0.05):
    """Random stepwise addition: one diverse fleet start.

    Leaves join in a random order, each attaching onto a uniformly random
    existing edge (the attachment splits that edge with a fresh internal
    node). Branch lengths start flat at ``init_blen`` — the fleet's first
    fit replaces them, only the topology matters here. Returns an
    index-topological ``(children, blen, root)``.
    """
    M = 2 * n_leaves - 1
    children = np.full((M, 2), -1, np.int32)
    blen = np.full((M, 2), init_blen, np.float32)
    perm = [int(x) for x in rng.permutation(n_leaves)]
    root = n_leaves
    children[root] = (perm[0], perm[1])
    nxt = root + 1
    edges = [(root, 0), (root, 1)]
    for leaf in perm[2:]:
        p, s = edges[int(rng.integers(len(edges)))]
        a = nxt
        nxt += 1
        children[a] = (int(children[p, s]), leaf)
        children[p, s] = a
        edges.append((a, 0))
        edges.append((a, 1))
    return normalize_tree(children, blen, root, n_leaves)


def fleet_starts(msa, *, k: int, gap_code: int, n_chars: int,
                 correct: bool = True, seed: int = 0, device=None):
    """K starting topologies: NJ, cluster-medoid skeleton, random addition.

    Returns ``(starts, labels)`` where each start is an index-topological
    ``(children, blen, root)`` and ``labels`` names the strategy per slot
    (``"nj"``, ``"cluster"``, ``"random<i>"``). The NJ and cluster
    distances run on ``device`` (kernel 2 on the card): by default a
    tensor ``msa``'s own device, else ``cuda``, which raises without a
    card. NJ's slightly negative lengths are floored at zero, matching
    ``MLRefiner``.
    """
    if isinstance(msa, torch.Tensor):
        msa_t = msa if device is None else msa.to(resolve_device(device))
    else:
        msa_t = torch.from_numpy(np.array(msa)).to(
            resolve_device("cuda" if device is None else device))
    n = msa_t.shape[0]
    starts, labels = [], []
    D = dist_mod.distance_matrix(msa_t, gap_code=gap_code, n_chars=n_chars,
                                 correct=correct)
    ch, bl, rt = nj_mod.host_tree(nj_mod.neighbor_joining(D, n))
    starts.append(normalize_tree(ch, np.maximum(bl, 0.0), rt, n))
    labels.append("nj")
    if k >= 2:
        cp = cluster_mod.cluster_phylogeny(
            msa_t, gap_code=gap_code, n_chars=n_chars,
            cfg=cluster_mod.ClusterConfig(seed=seed, correct=correct))
        starts.append(normalize_tree(np.asarray(cp.children),
                                     np.maximum(np.asarray(cp.blen), 0.0),
                                     int(cp.root), n))
        labels.append("cluster")
    for i in range(len(starts), k):
        rng = np.random.default_rng((seed, i))
        starts.append(random_addition_tree(n, rng))
        labels.append(f"random{i}")
    return starts, tuple(labels)


# -------------------------------------------------------------------- moves

def _parent_map(children, order) -> Dict[int, Tuple[int, int]]:
    """node -> (parent, slot) for every non-root node."""
    children = np.asarray(children)
    par: Dict[int, Tuple[int, int]] = {}
    for p in order:
        p = int(p)
        par[int(children[p, 0])] = (p, 0)
        par[int(children[p, 1])] = (p, 1)
    return par


def _postorder_all(children, root: int) -> np.ndarray:
    """Every node (leaves too) in ``topological_order``'s DFS postorder:
    child 0's subtree, child 1's, then the node."""
    out = []
    stack = [(int(root), False)]
    while stack:
        node, expanded = stack.pop()
        if expanded or children[node, 0] < 0:
            out.append(node)
        else:
            stack.append((node, True))
            stack.append((int(children[node, 1]), False))
            stack.append((int(children[node, 0]), False))
    return np.asarray(out, np.int64)


class _Splicer:
    """Postorders of SPR candidates, spliced from the input tree's.

    In a full postorder (leaves included) every subtree is one contiguous
    block ending at its root. Pruning v (parent u) removes v's block and u;
    regrafting v onto the edge above y puts, in y's block's place, the two
    blocks in u's slot order and then u. The internal nodes of the result,
    in order, are what ``topological_order`` returns for the candidate.
    """

    def __init__(self, children, root: int, par):
        self.internal = children[:, 0] >= 0
        self.post = _postorder_all(children, root)
        self.pos = np.empty(children.shape[0], np.int64)
        self.pos[self.post] = np.arange(len(self.post))
        self.size = np.ones(children.shape[0], np.int64)
        for node in self.post:
            if self.internal[node]:
                c0, c1 = children[node]
                self.size[node] = 1 + self.size[c0] + self.size[c1]
        self.par = par

    def _block(self, post, pos, size, node):
        return post[pos[node] - size[node] + 1: pos[node] + 1]

    def prune(self, v: int, u: int):
        """(postorder, positions, subtree sizes) of the tree without v's
        subtree and u (u's other child in u's place)."""
        a, b, pu = (self.pos[v] - self.size[v] + 1, self.pos[v] + 1,
                    self.pos[u])
        post = np.concatenate([self.post[:a], self.post[b:pu],
                               self.post[pu + 1:]])
        pos = np.empty_like(self.pos)
        pos[post] = np.arange(len(post))
        size = self.size.copy()
        x = u
        while x in self.par:
            x = self.par[x][0]
            size[x] -= self.size[v] + 1
        return post, pos, size

    def regraft(self, pruned, v: int, u: int, sv: int, y: int) -> np.ndarray:
        """Internal-node postorder of the pruned tree with u (children v in
        slot ``sv`` and y) on the edge above y."""
        post, pos, size = pruned
        a, b = pos[y] - size[y] + 1, pos[y] + 1
        vb = self._block(self.post, self.pos, self.size, v)
        pair = (vb, post[a:b]) if sv == 0 else (post[a:b], vb)
        new = np.concatenate([post[:a], *pair, [u], post[b:]])
        return new[self.internal[new]]


def spr_candidates(children, blen, order, n_leaves: int, radius: int):
    """Bounded-radius subtree prune-and-regraft candidates.

    For every node v whose parent u is not the root, prune the subtree at
    v: u is suppressed — its sibling child w inherits the merged edge to
    u's parent g (lengths summed) — and u's node id is held back as the
    regraft attachment, so the array size and the root id never change.
    v then regrafts onto any edge (x, y) of the pruned tree within
    ``radius`` hops of the wound: the attachment u splits that edge in
    half, v keeps its pendant length.

    Hop distance: BFS over the pruned tree from both wound endpoints
    {g, w} at depth 0; edge (x, y) sits at ``1 + min(depth(x),
    depth(y))``. ``radius=1`` is the NNI-sized neighborhood (the <= 4
    edges adjacent to the wound); a radius >= the tree diameter
    enumerates every target — ``2*(N - leaves(v)) - 3`` per prune node
    (the merged edge (g, w) is excluded: regrafting there recreates the
    input topology).

    Returns stacked ``(K, M, 2)`` children/blen and ``(K, M-N)`` orders
    like ``ml.nni_candidates``; each candidate carries a freshly computed
    postorder. Candidate order is deterministic (prune nodes ascending,
    targets ascending by child id) — ties in downstream argmax resolve
    identically on every run.

    The reference walks the whole pruned tree per prune node, copies
    arrays per candidate and recomputes each candidate's postorder by a
    DFS (``topological_order``); here the walk stops at the radius, each
    prune node's candidates are built as one array, and the postorders
    are spliced from the input tree's (``_Splicer``) — the same arrays,
    in the same order.
    """
    children = np.asarray(children)
    blen = np.asarray(blen)
    order = [int(x) for x in order]
    root = order[-1] if order else int(2 * n_leaves - 2)
    par = _parent_map(children, order)
    splice = _Splicer(children, root, par)
    out_ch, out_bl, out_od = [], [], []
    for v in range(children.shape[0]):
        if v == root or v not in par:
            continue
        u, sv = par[v]
        if u == root:
            continue                  # pruning a root child leaves no wound
        w = int(children[u, 1 - sv])
        g, su = par[u]
        chp = children.copy()
        blp = blen.copy()
        chp[g, su] = w
        blp[g, su] = blen[g, su] + blen[u, 1 - sv]
        parp = dict(par)
        parp[w] = (g, su)
        # BFS depths over the pruned tree from both wound endpoints; u and
        # v are unreachable (u was spliced out, v's only link was u). An
        # edge within the radius has an end at depth <= radius - 1, so
        # the walk stops expanding at depth ``radius``
        depth = {g: 0, w: 0}
        dq = deque((g, w))
        while dq:
            x = dq.popleft()
            if depth[x] >= radius:
                continue
            nbrs = []
            if chp[x, 0] >= 0:
                nbrs += [int(chp[x, 0]), int(chp[x, 1])]
            if x in parp and x != root:
                nbrs.append(parp[x][0])
            for nb in nbrs:
                if nb not in depth:
                    depth[nb] = depth[x] + 1
                    dq.append(nb)
        targets = []
        for y in sorted(depth):
            if y == root:
                continue              # no edge above the root
            x, sy = parp[y]
            if (x, y) == (g, w):
                continue              # merged edge: the input topology
            if 1 + min(depth.get(x, radius + 1), depth[y]) > radius:
                continue
            targets.append((x, sy, y))
        if not targets:
            continue
        # every regraft of v at once: u splits the edge (x, y) in half,
        # v keeps its pendant length (u's slot sv still holds v)
        X, SY, Y = (np.asarray(col) for col in zip(*targets))
        k = np.arange(len(targets))
        ch2 = np.repeat(chp[None], len(targets), axis=0)
        bl2 = np.repeat(blp[None], len(targets), axis=0)
        half = blp[X, SY] * 0.5
        ch2[k, u, 1 - sv] = Y
        bl2[k, u, sv] = blen[u, sv]
        bl2[k, u, 1 - sv] = half
        ch2[k, X, SY] = u
        bl2[k, X, SY] = half
        out_ch.append(ch2)
        out_bl.append(bl2)
        pruned = splice.prune(v, u)
        out_od.extend(splice.regraft(pruned, v, u, sv, int(y)) for y in Y)
    if not out_ch:
        return (np.zeros((0,) + children.shape, np.int32),
                np.zeros((0,) + blen.shape, np.float32),
                np.zeros((0, len(order)), np.int32))
    return (np.concatenate(out_ch).astype(np.int32),
            np.concatenate(out_bl).astype(np.float32),
            np.stack(out_od).astype(np.int32))


# ------------------------------------------------------------------ scoring

def score_fleet(patterns, weights, children_k, blen_k, order_k, params_k, *,
                model: str, site_chunk: int, n_cand=None,
                budget: int = MEMORY_BUDGET) -> np.ndarray:
    """(K, C) logL of every candidate of every search (host float32).

    ``children_k``/``blen_k`` are (K, C, M, 2), ``order_k`` (K, C, M-N),
    ``params_k`` (K, P) — each search scores its own candidates under its
    own fitted model parameters, as one forest in chunks of
    ``ml.scoring_plan``. All trees share the root M-1. With ``n_cand``
    (K,) given, only each search's first ``n_cand[k]`` candidates are
    evaluated; the padding columns read ``-inf``.
    """
    dev = patterns.device
    K, C, M, _ = children_k.shape
    real = np.ones((K, C), bool) if n_cand is None else \
        np.arange(C)[None, :] < np.asarray(n_cand)[:, None]
    kk, cc = np.nonzero(real)
    decs = [models.decompose(model, torch.as_tensor(
        np.asarray(params_k[k], np.float32), device=dev)) for k in range(K)]
    dec = models.Decomposition(*(torch.stack(x)[torch.from_numpy(kk).to(dev)]
                                 for x in zip(*decs)))
    lls = np.full((K, C), -np.inf, np.float32)
    lls[kk, cc] = score_trees(patterns, weights, children_k[kk, cc],
                              np.asarray(blen_k)[kk, cc], order_k[kk, cc],
                              M - 1, dec, site_chunk=site_chunk,
                              budget=budget)
    return lls


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


# ------------------------------------------------------------------- fleet

class TreeSearchResult(NamedTuple):
    children: np.ndarray      # (2N-1, 2) int32, index-topological again
    blen: np.ndarray          # (2N-1, 2) float32 optimized lengths
    root: int
    model: str                # fitted (or BIC-selected) model
    params: np.ndarray        # best start's unconstrained parameters
    logl_init: float          # NJ start under JC69 (MLResult convention)
    logl_final: float         # best start's final logL
    bic: Dict[str, float]     # per-candidate-model BIC (NJ start)
    best_start: int
    start_labels: Tuple[str, ...]
    trajectories: np.ndarray  # (K, rounds+1) f32 per-start logL per round
    n_moves: np.ndarray       # (K, 2) int32 accepted (nni, spr) per start
    round_seconds: np.ndarray  # (rounds+1,) wall seconds per executed round


class _Rounds:
    """The trivial ``batches`` protocol for ResilientLoop: batch == step."""

    def __init__(self, n_steps: int):
        self.n_steps = n_steps

    def __call__(self, step: int) -> int:
        return step


@dataclasses.dataclass(frozen=True)
class TreeSearcher:
    """Configured K-start search on ``device``; nucleotide alignments only
    (4 states). ``search`` runs under ``_deterministic``: the same input
    gives the same bits on a card, resumed or not.

    With ``ckpt_dir`` set the fleet state checkpoints per round and the
    loop runs under ``ResilientLoop`` — pass ``resume=True`` to continue
    a killed search from its newest checkpoint (same config required:
    the state shapes must match). ``failure_hook``/``max_failures``
    forward to the loop (chaos injection).
    """

    gap_code: int
    n_chars: int = 5
    correct: bool = True
    starts: int = 4
    spr_radius: int = 3
    rounds: int = 12              # max move rounds (beyond the initial fit)
    model: str = "auto"           # auto = BIC over the registry (NJ start)
    steps: int = 100              # adam steps per fit
    lr: float = 0.05
    min_gain: float = 1e-2        # logL gain a move must clear
    site_chunk: int = 2048
    seed: int = 0
    mesh: Optional[object] = None     # a dist.sharding.Mesh (scoring)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1
    ckpt_keep: Optional[int] = 3
    resume: bool = False
    failure_hook: Optional[Callable[[int], None]] = None
    max_failures: Optional[int] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.model != "auto":
            models.validate(self.model)
        if self.starts < 1:
            raise ValueError(f"need at least one start, got {self.starts}")

    # ------------------------------------------------------------- search

    def search(self, msa, *, patterns=None, weights=None) -> TreeSearchResult:
        """Run the fleet; returns the best start's renumbered tree.

        ``patterns``/``weights`` accept a precomputed
        ``compress_patterns(msa)``.
        """
        dev = resolve_device(self.device)
        n = msa.shape[0]
        if n < 3:
            raise ValueError(f"tree search needs >= 3 sequences, got {n}")
        patterns_np, weights_np, patterns, weights = _patterns(
            msa, patterns, weights, dev)
        n_sites = float(weights_np.sum())
        K = self.starts
        M = 2 * n - 1
        root = M - 1
        fit_kw = dict(steps=self.steps, lr=self.lr,
                      site_chunk=self.site_chunk)

        with _deterministic(), _trace.span(
                "tree.search", starts=K, spr_radius=self.spr_radius,
                rounds=self.rounds, mesh=self.mesh is not None) as sp:
            starts, labels = fleet_starts(
                msa, k=K, gap_code=self.gap_code, n_chars=self.n_chars,
                correct=self.correct, seed=self.seed, device=dev)
            ch0 = np.stack([s[0] for s in starts]).astype(np.int32)
            bl0 = np.stack([s[1] for s in starts]).astype(np.float32)
            order = np.arange(n, M, dtype=np.int32)
            od0 = np.broadcast_to(order, (K, M - n)).copy()

            dec0 = models.decompose("jc69", torch.zeros(0, device=dev))
            with torch.no_grad():
                logl_init = float(lik.pruning_log_likelihood(
                    patterns, weights, ch0[0], torch.from_numpy(bl0[0]),
                    order, root, dec0.lam, dec0.U, dec0.sp, dec0.pi,
                    site_chunk=self.site_chunk))

            # model selection on the NJ start only: one model for the whole
            # fleet keeps every search's params the same shape (the state
            # must be fixed-shape for checkpointing)
            freqs = models.empirical_freqs(patterns_np, weights_np)
            candidates = models.MODELS if self.model == "auto" \
                else (self.model,)
            bics = {}
            for m in candidates:
                with _trace.span("ml.fit", model=m):
                    _, _, ll_m = _fit(patterns, weights, ch0[0], order, root,
                                      bl0[0], models.init_params(m, freqs),
                                      model=m, **fit_kw)
                    bics[m] = models.bic(float(ll_m), m, 2 * n - 2, n_sites)
            model = min(bics, key=bics.get)
            params0 = np.asarray(models.init_params(model, freqs), np.float32)

            state0 = {
                "active": np.ones((K,), np.int8),
                "blen": bl0,
                "children": ch0,
                "logl": np.full((K,), -np.inf, np.float32),
                "moves": np.zeros((K, 2), np.int32),
                "order": od0,
                "params": np.broadcast_to(params0, (K,) + params0.shape
                                          ).astype(np.float32).copy(),
                "round": np.zeros((), np.int32),
                "traj": np.full((K, self.rounds + 1), np.nan, np.float32),
            }

            round_secs: Dict[int, float] = {}
            step_fn = self._make_step(patterns, weights, model, n, root,
                                      round_secs)

            if self.ckpt_dir is not None:
                from ..dist.checkpoint import CheckpointManager
                from ..dist.fault import ResilientLoop
                loop = ResilientLoop(step_fn,
                                     CheckpointManager(self.ckpt_dir,
                                                       keep=self.ckpt_keep,
                                                       mesh=self.mesh),
                                     ckpt_every=self.ckpt_every,
                                     failure_hook=self.failure_hook,
                                     max_failures=self.max_failures)
                state, _ = loop.run(state0, _Rounds(self.rounds + 1),
                                    resume=self.resume)
            else:
                state = state0
                for r in range(self.rounds + 1):
                    state = step_fn(state, r)

            st = {k: np.asarray(v) for k, v in state.items()}
            best = int(np.argmax(st["logl"]))
            ch_b, bl_b, root_b = renumber_topological(
                st["children"][best], st["blen"][best], root,
                st["order"][best], n)
            secs = np.zeros(self.rounds + 1, np.float32)
            for r, s in round_secs.items():
                secs[r] = s
            if sp is not None:
                sp.attrs.update(model=model, best_start=best,
                                logl_final=float(st["logl"][best]),
                                per_start_logl=[float(x)
                                                for x in st["logl"]],
                                n_moves=int(st["moves"].sum()))
            return TreeSearchResult(
                ch_b, bl_b, root_b, model, st["params"][best], logl_init,
                float(st["logl"][best]), bics, best, labels, st["traj"],
                st["moves"], secs)

    # ------------------------------------------------------------ internals

    def _score(self, patterns, weights, ch_k, bl_k, od_k, prm, n_cand,
               model: str) -> np.ndarray:
        """(K, C) candidate block -> (K, C) logL, on one device or split
        by search over the mesh's data axis."""
        if self.mesh is None:
            return score_fleet(patterns, weights, ch_k, bl_k, od_k, prm,
                               model=model, site_chunk=self.site_chunk,
                               n_cand=n_cand)
        from ..dist import mapreduce
        from ..dist import sharding as sh
        n_shards = sh.axis_size(self.mesh, "data")
        per = -(-ch_k.shape[0] // n_shards)
        blk = slice(self.mesh.block_index("data") * per, None)
        # this rank's searches; padding searches have no candidates
        parts = [mapreduce.pad_rows(x, n_shards)[0][blk][:per]
                 for x in (ch_k, bl_k, od_k, prm, n_cand)]
        fn = mapreduce.treesearch_over_mesh(self.mesh, model=model,
                                            site_chunk=self.site_chunk)
        return mapreduce.unpad_rows(fn(patterns, weights, *parts),
                                    ch_k.shape[0])

    def _make_step(self, patterns, weights, model: str, n: int, root: int,
                   round_secs: Dict[int, float]):
        """The per-round step function ResilientLoop replays.

        Round 0 is the initial per-start fit; round r >= 1 generates
        NNI+SPR candidates for every active search, scores them in one
        forest, and per search either accepts the best strictly-improving
        move (then refits) or deactivates. Everything is a deterministic
        function of the state dict, so checkpoint replay is bit-exact.
        """
        K, M = self.starts, 2 * n - 1
        fit_kw = dict(model=model, steps=self.steps, lr=self.lr,
                      site_chunk=self.site_chunk)

        def refit(ch, bl, od, prm, k):
            with _trace.span("ml.fit", model=model, start=k):
                b, p, ll = _fit(patterns, weights, ch[k], od[k], root, bl[k],
                                prm[k], **fit_kw)
                return _host(b), _host(p), float(ll)

        def step_fn(state, _step):
            t0 = time.perf_counter()
            st = {k: np.array(v) for k, v in state.items()}
            r = int(st["round"])
            ch, bl, od = st["children"], st["blen"], st["order"]
            prm, logl = st["params"], st["logl"]
            active, traj, moves = st["active"], st["traj"], st["moves"]

            if r == 0:
                for k in range(K):
                    bl[k], prm[k], logl[k] = refit(ch, bl, od, prm, k)
                traj[:, 0] = logl
            else:
                with _trace.span("search.round", round=r) as sp:
                    cands, n_cand = {}, np.zeros(K, np.int64)
                    for k in range(K):
                        if not active[k]:
                            continue
                        chn, bln, odn = nni_candidates(ch[k], bl[k],
                                                       od[k], n)
                        chs, bls, ods = spr_candidates(
                            ch[k], bl[k], od[k], n, radius=self.spr_radius)
                        cands[k] = (np.concatenate([chn, chs]),
                                    np.concatenate([bln, bls]),
                                    np.concatenate([odn, ods]),
                                    chn.shape[0])
                        n_cand[k] = cands[k][0].shape[0]
                    accepted = 0
                    if n_cand.max(initial=0) > 0:
                        # the reference's (K, Cmax) block, padded with
                        # copies of each search's current tree; the padding
                        # is not evaluated (score_fleet's n_cand)
                        Cmax = _pow2ceil(int(n_cand.max()))
                        ch_k = np.broadcast_to(ch[:, None], (K, Cmax, M, 2)
                                               ).copy()
                        bl_k = np.broadcast_to(bl[:, None], (K, Cmax, M, 2)
                                               ).copy()
                        od_k = np.broadcast_to(od[:, None], (K, Cmax, M - n)
                                               ).copy()
                        for k, c in cands.items():
                            ch_k[k, :n_cand[k]] = c[0]
                            bl_k[k, :n_cand[k]] = c[1]
                            od_k[k, :n_cand[k]] = c[2]
                        with _trace.span("search.score",
                                         candidates=int(n_cand.sum())):
                            lls = self._score(patterns, weights, ch_k, bl_k,
                                              od_k, prm, n_cand, model)
                        for k in range(K):
                            if not active[k]:
                                continue
                            best = int(np.argmax(lls[k]))
                            if float(lls[k, best]) <= float(logl[k]) \
                                    + self.min_gain:
                                active[k] = 0
                                continue
                            c = cands[k]
                            ch[k], bl[k], od[k] = (c[0][best], c[1][best],
                                                   c[2][best])
                            bl[k], prm[k], logl[k] = refit(ch, bl, od, prm,
                                                           k)
                            kind = "nni" if best < c[3] else "spr"
                            moves[k, 0 if kind == "nni" else 1] += 1
                            _C_MOVES.labels(kind=kind).inc()
                            accepted += 1
                    else:
                        active[:] = 0
                    traj[:, r] = logl
                    if sp is not None:
                        sp.attrs.update(accepted=accepted,
                                        n_active=int(active.sum()),
                                        best_logl=float(np.max(logl)))
            _C_ROUNDS.inc()
            round_secs[r] = time.perf_counter() - t0
            return {"active": active, "blen": bl, "children": ch,
                    "logl": logl, "moves": moves, "order": od,
                    "params": prm, "round": np.int32(r + 1), "traj": traj}

        return step_fn
