"""Substitution-model registry: JC69 / K80 / HKY85 / GTR as one family.

Every model is a point in the general-time-reversible family: a symmetric
exchangeability matrix R (6 pairwise rates over A,C,G,T) and a stationary
distribution pi, composed as ``Q_ij = R_ij * pi_j`` with the diagonal set
so rows sum to zero and the whole matrix scaled to one expected
substitution per unit branch length. Transition probabilities come from
the eigendecomposition of the pi-symmetrized rate matrix
``S = diag(sqrt(pi)) Q diag(1/sqrt(pi))``:

    P(t) = diag(1/sqrt(pi)) U exp(Lambda t) U^T diag(sqrt(pi))

| model | free params | constraints                                   |
|-------|-------------|-----------------------------------------------|
| jc69  | 0           | all rates equal, pi uniform                   |
| k80   | 1 (kappa)   | transitions (A<->G, C<->T) scaled, pi uniform |
| hky85 | 4           | kappa + free pi                               |
| gtr   | 8           | 5 free rates (GT fixed = 1) + free pi         |

The equal-frequency models (jc69, k80) share a parameter-independent
eigenbasis (``_EQ_BASIS``), so their decomposition is closed-form.
HKY85/GTR decompose numerically: a fixed number of parallel Jacobi sweeps
in float64 (``_sym_eig4``), started from that basis. The reference calls
``eigh``; ``torch.linalg.eigh`` waits for the host on a CUDA device (it
reads back a convergence flag), which would put a host sync in every
optimizer step, and the sweeps are plain differentiable tensor ops. The
eigenvector order and signs differ from ``eigh``'s; P(t) does not.

Unconstrained parameter vectors (what the optimizer sees): rates and
kappa through ``exp``, pi through a softmax with the T logit pinned to 0.
Model selection is by BIC (``bic``): k = free model params + 2N-2 branch
lengths, n = alignment columns (not unique patterns).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

MODELS = ("jc69", "k80", "hky85", "gtr")

N_FREE = {"jc69": 0, "k80": 1, "hky85": 4, "gtr": 8}

# symmetric pair order of the 6 exchangeabilities over A,C,G,T = 0..3
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_TRANSITIONS = (1, 4)      # AG and CT entries of _PAIRS (the kappa pairs)

# shared eigenbasis of every equal-frequency model (columns: stationary
# mode, purine-vs-pyrimidine, A-vs-G, C-vs-T)
_EQ_BASIS = np.array([
    [0.5,  0.5,  np.sqrt(0.5),  0.0],
    [0.5, -0.5,  0.0,           np.sqrt(0.5)],
    [0.5,  0.5, -np.sqrt(0.5),  0.0],
    [0.5, -0.5,  0.0,          -np.sqrt(0.5)],
], np.float32)

# parallel Jacobi: each round rotates two disjoint index pairs; three
# rounds are one sweep over all six pairs
_JACOBI_ROUNDS = (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2)))
_JACOBI_SWEEPS = 4


_CONSTANTS: dict = {}


def _const(name: str, device, make):
    """``make()`` moved to ``device``, built once per device: a
    host-to-device copy inside every optimizer step would wait for the
    device's queue."""
    key = (name, str(device))
    if key not in _CONSTANTS:
        made = make()
        _CONSTANTS[key] = (made.to(device) if isinstance(made, torch.Tensor)
                           else [tuple(t.to(device) for t in r)
                                 for r in made])
    return _CONSTANTS[key]


def _pair_index(device):
    """Row and column indices of the 6 pairs, both triangles."""
    return _const("pairs", device, lambda: torch.tensor(
        [[a for a, _ in _PAIRS] + [b for _, b in _PAIRS],
         [b for _, b in _PAIRS] + [a for a, _ in _PAIRS]]))


def _eq_basis(device, dtype=torch.float32):
    return _const(f"eq_basis_{dtype}", device,
                  lambda: torch.as_tensor(_EQ_BASIS, dtype=dtype))


def _make_jacobi_rounds():
    """Per round: the two planes' (p, q) indices, and the masks of
    ``E_pp + E_qq`` and ``E_pq - E_qp`` for each plane."""
    eye = torch.eye(4, dtype=torch.float64)
    return [(torch.tensor([p for p, _ in pairs]),
             torch.tensor([q for _, q in pairs]),
             torch.stack([eye[p, :, None] * eye[p] + eye[q, :, None] * eye[q]
                          for p, q in pairs]),
             torch.stack([eye[p, :, None] * eye[q] - eye[q, :, None] * eye[p]
                          for p, q in pairs]))
            for pairs in _JACOBI_ROUNDS]


class Decomposition(NamedTuple):
    """Eigendecomposed reversible model, ready for ``P(t)`` evaluation
    (``core.likelihood`` consumes lam/U/sp directly)."""
    lam: torch.Tensor    # (4,) eigenvalues of the symmetrized rate matrix
    U: torch.Tensor      # (4, 4) orthonormal eigenvectors (columns)
    sp: torch.Tensor     # (4,) sqrt(pi)
    pi: torch.Tensor     # (4,) stationary distribution


def validate(model: str) -> str:
    if model not in MODELS:
        raise ValueError(f"unknown substitution model {model!r}; "
                         f"expected one of {MODELS}")
    return model


def empirical_freqs(patterns, weights) -> np.ndarray:
    """Weighted A,C,G,T frequencies of an alignment (gaps/N excluded),
    host numpy. Pseudocounts plus a tiny deterministic tilt keep the
    result off the exactly-uniform point, where HKY85's eigenvalues
    degenerate."""
    patterns = np.asarray(patterns)
    weights = np.asarray(weights, np.float64)
    counts = np.zeros(4)
    for c in range(4):
        counts[c] = ((patterns == c) * weights[None, :]).sum()
    counts += 1.0 + 1e-3 * np.arange(4)
    return (counts / counts.sum()).astype(np.float32)


def init_params(model: str, freqs: Optional[np.ndarray] = None) -> np.ndarray:
    """Unconstrained starting point for the optimizer (f32 numpy): kappa
    at 2, GTR rates at distinct transition-biased values, pi logits at
    the empirical frequencies when given."""
    validate(model)
    if freqs is None:
        freqs = np.array([0.27, 0.23, 0.24, 0.26], np.float32)
    logits = np.log(np.maximum(freqs[:3], 1e-6) / max(float(freqs[3]), 1e-6))
    if model == "jc69":
        return np.zeros(0, np.float32)
    if model == "k80":
        return np.array([np.log(2.0)], np.float32)
    if model == "hky85":
        return np.concatenate([[np.log(2.0)], logits]).astype(np.float32)
    rates = np.log([1.1, 2.0, 0.9, 1.05, 2.1])     # AC AG AT CG CT (GT = 1)
    return np.concatenate([rates, logits]).astype(np.float32)


def _param_tensor(params, device=None) -> torch.Tensor:
    if isinstance(params, torch.Tensor):
        return params.to(torch.float32)
    return torch.as_tensor(np.asarray(params, np.float32), device=device)


def unpack(model: str, params):
    """Unconstrained params -> (rates (6,), pi (4,)) in model constraints."""
    validate(model)
    params = _param_tensor(params)
    dev = params.device
    uniform = torch.full((4,), 0.25, dtype=torch.float32, device=dev)
    ones = torch.ones(6, dtype=torch.float32, device=dev)
    if model == "jc69":
        return ones, uniform
    if model in ("k80", "hky85"):
        kappa = torch.exp(params[0])
        rates = ones.index_put(
            (_const("transitions", dev,
                    lambda: torch.tensor(_TRANSITIONS)),), kappa.expand(2))
        if model == "k80":
            return rates, uniform
        pi = torch.softmax(torch.cat([params[1:4], ones[:1] * 0]), dim=0)
        return rates, pi
    rates = torch.cat([torch.exp(params[:5]), ones[:1]])
    pi = torch.softmax(torch.cat([params[5:8], ones[:1] * 0]), dim=0)
    return rates, pi


def rate_matrix(model: str, params):
    """(Q, pi): the normalized GTR-family rate matrix (1 sub/site/unit t)."""
    rates, pi = unpack(model, params)
    ij = _pair_index(rates.device)
    R = torch.zeros((4, 4), dtype=torch.float32,
                    device=rates.device).index_put(
        (ij[0], ij[1]), torch.cat([rates, rates]))
    Q = R * pi[None, :]
    Q = Q - torch.diag(torch.sum(Q, dim=1))
    mu = -torch.sum(pi * torch.diagonal(Q))
    return Q / torch.clamp(mu, min=1e-12), pi


def _sym_eig4(S):
    """(lam, U) of a symmetric 4x4 by ``_JACOBI_SWEEPS`` sweeps of parallel
    Jacobi in float64, started from ``_EQ_BASIS`` (the exact basis at
    uniform pi, close to it elsewhere). Each round rotates its two
    disjoint planes at once by the inner angle that zeroes A[p, q] of
    J^T A J: ``tan 2theta = 2 A[p, q] / (A[q, q] - A[p, p])`` with
    ``|theta| <= pi/4``, the choice under which cyclic Jacobi converges
    quadratically. Plain differentiable tensor ops: no host round
    trip."""
    dev = S.device
    V = _eq_basis(dev, torch.float64)
    A = V.T @ S.to(torch.float64) @ V
    eye = _const("eye64", dev, lambda: torch.eye(4, dtype=torch.float64))
    rounds = _const("jacobi", dev, _make_jacobi_rounds)
    for _ in range(_JACOBI_SWEEPS):
        for P, Q, diag, skew in rounds:
            y = 2.0 * A[P, Q]
            d = torch.diagonal(A)
            x = d[Q] - d[P]
            # atan2's gradient is 0/0 at the origin: keep x away from it
            x = torch.where((y.abs() + x.abs()) > 1e-300, x,
                            torch.ones_like(x))
            # the inner angle: 2theta in [-pi/2, pi/2]
            phi = 0.5 * torch.atan2(torch.where(x < 0, -y, y), x.abs())
            J = eye + torch.einsum("k,kij->ij", torch.cos(phi) - 1.0, diag) \
                + torch.einsum("k,kij->ij", torch.sin(phi), skew)
            A = J.T @ A @ J
            V = V @ J
    return torch.diagonal(A).to(torch.float32), V.to(torch.float32)


def decompose(model: str, params) -> Decomposition:
    """Eigendecompose the pi-symmetrized rate matrix.

    jc69/k80 use the fixed equal-frequency eigenbasis (their eigenvalues
    are degenerate); hky85/gtr go through ``_sym_eig4``.
    """
    Q, pi = rate_matrix(model, params)
    sp = torch.sqrt(pi)
    S = sp[:, None] * Q / sp[None, :]
    S = 0.5 * (S + S.T)
    if model in ("jc69", "k80"):
        U = _eq_basis(S.device)
        lam = torch.einsum("ki,kl,li->i", U, S, U)
    else:
        lam, U = _sym_eig4(S)
    return Decomposition(lam, U, sp, pi)


def bic(logl: float, model: str, n_branches: int, n_sites: float) -> float:
    """Bayesian information criterion: k ln(n) - 2 logL (lower is better).

    k counts the free substitution parameters plus every branch length;
    n is the number of alignment columns (patterns expanded by weight).
    """
    k = N_FREE[validate(model)] + n_branches
    return float(k * np.log(max(n_sites, 1.0)) - 2.0 * logl)
