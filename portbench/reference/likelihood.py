"""Plain reference of maximum-likelihood tree refinement. Imports nothing
of the program.

* Models: the general-time-reversible family (jc69, k80, hky85, gtr)
  from their unconstrained parameters: kappa and the GTR rates through
  ``exp`` (GT = 1), the stationary distribution through a softmax with
  the T logit at 0; Q_ij = R_ij pi_j scaled to one substitution per unit
  length; P(t) = expm(Q max(t, 0)).
* ``loglik``: Felsenstein pruning over site patterns, the nodes of one
  height at a time, each node's partial rescaled by its largest entry.
* ``fit``: Adam (lr, betas 0.9 / 0.999, eps 1e-8) on softplus branch
  lengths and the model's parameters; the best point of the trajectory,
  its start and its end included.
* ``nni_candidates``, ``renumber``: the two interchanges around every
  internal edge, each with its processing order; relabelling internal
  nodes into their order.
* ``refine``: the whole refinement (every model fitted, BIC, NNI rounds)
  for the control run in the program's place.

``dtype`` is float64 for the reference. ``tf32=True`` rounds both
operands of every product to TF32 (10 mantissa bits) before a float32
product: what float32 products with TF32 on compute.
"""
from __future__ import annotations

import numpy as np
import torch

MODELS = ("jc69", "k80", "hky85", "gtr")
N_FREE = {"jc69": 0, "k80": 1, "hky85": 4, "gtr": 8}
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def compress(msa: np.ndarray):
    cols, counts = np.unique(np.asarray(msa).T, axis=0, return_counts=True)
    return np.ascontiguousarray(cols.T).astype(np.int64), \
        counts.astype(np.float64)


def empirical_freqs(patterns, weights) -> np.ndarray:
    """Weighted A, C, G, T frequencies with pseudocounts 1 + 1e-3 c."""
    counts = np.array([((patterns == c) * weights[None, :]).sum()
                       for c in range(4)], np.float64)
    counts += 1.0 + 1e-3 * np.arange(4)
    return (counts / counts.sum()).astype(np.float32)


def init_params(model: str, freqs) -> np.ndarray:
    """Starting point: kappa 2, GTR rates (AC, AG, AT, CG, CT) 1.1, 2,
    0.9, 1.05, 2.1, pi logits at the empirical frequencies."""
    logits = np.log(np.maximum(freqs[:3], 1e-6) / max(float(freqs[3]),
                                                      1e-6))
    if model == "jc69":
        return np.zeros(0, np.float32)
    if model == "k80":
        return np.array([np.log(2.0)], np.float32)
    if model == "hky85":
        return np.concatenate([[np.log(2.0)], logits]).astype(np.float32)
    rates = np.log([1.1, 2.0, 0.9, 1.05, 2.1])
    return np.concatenate([rates, logits]).astype(np.float32)


def rate_matrix(model: str, p: torch.Tensor):
    dt, dev = p.dtype, p.device
    rates = torch.ones(6, dtype=dt, device=dev)
    pi = torch.full((4,), 0.25, dtype=dt, device=dev)
    zero = torch.zeros(1, dtype=dt, device=dev)
    if model in ("k80", "hky85"):
        kappa = torch.exp(p[0])
        rates = torch.stack([rates[0], kappa, rates[2], rates[3], kappa,
                             rates[5]])
        if model == "hky85":
            pi = torch.softmax(torch.cat([p[1:4], zero]), dim=0)
    elif model == "gtr":
        rates = torch.cat([torch.exp(p[:5]), zero + 1.0])
        pi = torch.softmax(torch.cat([p[5:8], zero]), dim=0)
    R = torch.zeros((4, 4), dtype=dt, device=dev)
    for k, (a, b) in enumerate(_PAIRS):
        R = R.index_put((torch.tensor([a, b], device=dev),
                         torch.tensor([b, a], device=dev)),
                        rates[k].expand(2))
    Q = R * pi[None, :]
    Q = Q - torch.diag(Q.sum(dim=1))
    mu = -(pi * torch.diagonal(Q)).sum()
    return Q / mu, pi


def _tf32(x):
    """``x`` rounded to TF32's 10 mantissa bits (nearest, ties to even);
    the gradient passes through unrounded."""
    b = x.detach().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return x + (b.view(torch.float32) - x).detach()


def _heights(children, order, n):
    h = np.zeros(children.shape[0], np.int64)
    for v in order:
        a, b = children[v]
        h[v] = 1 + max(h[a], h[b])
    return h


def loglik(patterns, weights, children, blen, order, root, model, params,
           *, dtype=torch.float64, tf32=False):
    """Pruning logL (0-d tensor) of one tree; ``blen`` and ``params``
    may carry gradients. ``patterns`` (N, P) int64 and ``weights`` (P,)
    tensors on the device; tree arrays on the host (``order`` a
    topological order of the internal nodes)."""
    dev = patterns.device
    children = np.asarray(children, np.int64)
    order = np.asarray(order, np.int64)
    N = patterns.shape[0]
    params = torch.as_tensor(params, device=dev).to(dtype)
    blen = torch.as_tensor(blen, device=dev).to(dtype)
    Q, pi = rate_matrix(model, params)
    t = torch.clamp(blen, min=0.0)                          # (M, 2)
    P = torch.linalg.matrix_exp(Q * t[..., None, None])     # (M, 2, 4, 4)
    Pt = P.transpose(-1, -2)
    codes = patterns[..., None]
    leaf = ((codes == torch.arange(4, device=dev)) | (codes >= 4)).to(dtype)
    h = _heights(children, order, N)
    slot = np.arange(children.shape[0])
    parts = leaf                                            # (slots, P, 4)
    scales = torch.zeros(leaf.shape[:2], dtype=dtype, device=dev)
    nxt = N
    for level in range(1, int(h[order].max(initial=0)) + 1):
        nodes = order[h[order] == level]
        slot[nodes] = nxt + np.arange(len(nodes))
        nxt += len(nodes)
        kids = torch.from_numpy(slot[children[nodes]]).to(dev)   # (n, 2)
        nt = torch.from_numpy(nodes).to(dev)
        L = parts[kids]                                      # (n, 2, P, 4)
        T = Pt[nt]                                           # (n, 2, 4, 4)
        if tf32:
            L, T = _tf32(L), _tf32(T)
        x = L @ T
        part = x[:, 0] * x[:, 1]
        m = torch.clamp(part.amax(dim=-1, keepdim=True), min=1e-300)
        sc = scales[kids[:, 0]] + scales[kids[:, 1]] + torch.log(m[..., 0])
        parts = torch.cat([parts, part / m])
        scales = torch.cat([scales, sc])
    r = int(slot[int(root)])
    site = torch.log((pi * parts[r]).sum(dim=-1)) + scales[r]
    return (weights.to(dtype) * site).sum()


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_softplus(y):
    y = torch.clamp(y, min=1e-6)
    return y + torch.log(-torch.expm1(-y))


def fit(patterns, weights, children, order, root, blen0, params0, model,
        *, steps, lr, dtype=torch.float64, tf32=False):
    """Best point of ``steps`` Adam steps from (blen0, params0): returns
    host (blen, params, logL)."""
    dev = patterns.device
    M = np.asarray(children).shape[0]
    raw = _inv_softplus(torch.as_tensor(np.asarray(blen0), device=dev)
                        .to(dtype)).reshape(-1)
    p = torch.cat([raw, torch.as_tensor(np.asarray(params0), device=dev)
                   .to(dtype)]).detach().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def nll(q):
        return -loglik(patterns, weights, children,
                       _softplus(q[:2 * M]).reshape(M, 2), order, root,
                       model, q[2 * M:], dtype=dtype, tf32=tf32)

    best, best_p = float("inf"), p.detach().clone()
    for _ in range(steps):
        opt.zero_grad()
        loss = nll(p)
        loss.backward()
        if loss.item() < best:
            best, best_p = loss.item(), p.detach().clone()
        opt.step()
    with torch.no_grad():
        final = float(nll(p))
        if final < best:
            best, best_p = final, p.detach().clone()
    bl = _softplus(best_p[:2 * M]).reshape(M, 2)
    return bl.cpu().numpy(), best_p[2 * M:].cpu().numpy(), -best


def nni_candidates(children, blen, order, n):
    """For every edge (p, c) between internal nodes (p's other child d,
    c's children a, b): d exchanged with a, and with b, the moved
    subtrees keeping their pendant lengths; the order with c moved to
    just before p. Returns a list of (children, blen, order)."""
    children = np.asarray(children)
    blen = np.asarray(blen)
    order = [int(v) for v in order]
    out = []
    for p in order:
        for ci in range(2):
            c = int(children[p, ci])
            if c < n:
                continue
            d = int(children[p, 1 - ci])
            od = [v for v in order if v != c]
            od.insert(od.index(p), c)
            for si in range(2):
                ch, bl = children.copy(), blen.copy()
                ch[p, 1 - ci], bl[p, 1 - ci] = children[c, si], blen[c, si]
                ch[c, si], bl[c, si] = d, blen[p, 1 - ci]
                out.append((ch, bl, np.asarray(od, np.int64)))
    return out


def renumber(children, blen, root, order, n):
    """Internal node ``order[i]`` becomes n + i."""
    children = np.asarray(children)
    new = np.arange(children.shape[0])
    for i, v in enumerate(order):
        new[int(v)] = n + i
    ch = np.full_like(children, -1)
    bl = np.zeros_like(np.asarray(blen))
    for v in range(children.shape[0]):
        if children[v, 0] >= 0:
            ch[new[v]] = new[children[v]]
            bl[new[v]] = blen[v]
    return ch, bl, int(new[int(root)])


def bic(ll: float, model: str, n_leaves: int, n_sites: float) -> float:
    k = N_FREE[model] + 2 * n_leaves - 2
    return float(k * np.log(max(n_sites, 1.0)) - 2.0 * ll)


def refine(patterns, weights, n_sites, children, blen, root, *, steps, lr,
           nni_rounds, min_gain, dtype=torch.float64, tf32=False):
    """The whole refinement from a start tree, recorded as the harness
    records the program's (``handoffs``: one entry a fit)."""
    n = patterns.shape[0]
    M = np.asarray(children).shape[0]
    blen = np.maximum(np.asarray(blen, np.float32), 0.0)
    order = np.arange(n, M)
    w_host = weights.cpu().numpy()
    freqs = empirical_freqs(patterns.cpu().numpy(), w_host)
    handoffs = []

    def run(ch, bl, od, params, model):
        b, p, ll = fit(patterns, weights, ch, od, root, bl, params, model,
                       steps=steps, lr=lr, dtype=dtype, tf32=tf32)
        b, p = b.astype(np.float32), p.astype(np.float32)
        handoffs.append(dict(children=np.asarray(ch), order=np.asarray(od),
                             root=int(root), blen0=np.asarray(bl),
                             params0=np.asarray(params), model=model,
                             blen=b, params=p, ll=float(ll)))
        return b, p, float(ll)

    with torch.no_grad():
        ll0 = float(loglik(patterns, weights, children, blen, order, root,
                           "jc69", np.zeros(0), dtype=dtype, tf32=tf32))
    fits = {m: run(children, blen, order, init_params(m, freqs), m)
            for m in MODELS}
    bics = {m: bic(fits[m][2], m, n, n_sites) for m in MODELS}
    model = min(bics, key=bics.get)
    bl, params, ll = fits[model]
    ch, od = np.asarray(children), order
    n_nni = 0
    for _ in range(nni_rounds):
        cands = nni_candidates(ch, bl, od, n)
        if not cands:
            break
        with torch.no_grad():
            lls = [float(loglik(patterns, weights, c, b, o, root, model,
                                params, dtype=dtype, tf32=tf32))
                   for c, b, o in cands]
        best = int(np.argmax(lls))
        if lls[best] <= ll + min_gain:
            break
        ch, _, od = cands[best]
        bl, params, ll = run(ch, cands[best][1], od, params, model)
        n_nni += 1
    ch, bl, rt = renumber(ch, bl, root, od, n)
    return dict(handoffs=handoffs, children=ch, blen=bl, root=rt,
                model=model, params=params, logl_init=ll0, logl_final=ll,
                n_nni=n_nni)
