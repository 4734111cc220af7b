"""AdamW with global-norm clipping as plain functions over the port's
parameter trees (dicts and lists of tensors); the port of
``repro/train/optimizer.py``.

The formula is the reference's, operation for operation, but for the
gradients' global norm, whose sum of squares is accumulated in f64 and
rounded to f32 once (``global_norm``): a clip to ``grad_clip``, linear
warmup on the step
count, bias corrections, and weight decay on every leaf from its f32
value, cast back to the parameter's type. ``torch.optim.AdamW`` is not
used: it clips, warms up and decays elsewhere and rounds in another
order. Every scalar (the count, the norm, the learning rate) stays a
0-d tensor on the parameters' device, so an update reads nothing back to
the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def _rebuild(like, items):
    """A list, tuple or named tuple of ``like``'s type holding ``items``."""
    items = list(items)
    return type(like)(*items) if hasattr(like, "_fields") \
        else type(like)(items)


def tree_map(fn, *trees):
    """``fn`` over the tensors of equally shaped trees of dicts, lists and
    tuples (named tuples too: ``OptState``, ``TrainState``); ``None``
    stays ``None``."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return _rebuild(t, (tree_map(fn, *xs) for xs in zip(*trees)))
    if t is None:
        return None
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The tensors of a tree in the reference's flatten order (a dict's
    values by sorted key, list items in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure with its tensors taken from ``leaves`` in
    flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return _rebuild(t, (build(x) for x in t))
        return None if t is None else next(it)
    return build(like)


def init(params) -> OptState:
    def z(p):
        return torch.zeros_like(p, dtype=torch.float32)
    dev = tree_leaves(params)[0].device
    return OptState(tree_map(z, params), tree_map(z, params),
                    torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in flatten order, of each leaf's
    f32 squares, accumulated in f64 and rounded to f32 once.

    On a mesh each leaf's sum is taken shard by shard and then across
    ranks, in another order than on one rank; in f64 that order moves the
    sum by ~1e-16 of itself, far below the f32 result's half ulp (3e-8),
    so the norm (and the clip it sets) stays bit for bit the one rank's.
    """
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum(g.float() ** 2, dtype=torch.float64)
    return torch.sqrt(total).float()


def update(params, grads, state: OptState, cfg: AdamWConfig):
    """-> (new params, new state, {"grad_norm", "lr"})."""
    count = state.count + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    grads = tree_map(lambda g: g.float() * scale, grads)

    lr = cfg.lr * torch.clamp(count / max(cfg.warmup_steps, 1), max=1.0)
    cf = count.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=cf.device), cf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=cf.device), cf)

    new_m = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g,
                     state.m, grads)
    new_v = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g,
                     state.v, grads)

    def upd(p, m, v):
        step = lr * (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        step = step + lr * cfg.weight_decay * p.float()
        return (p.float() - step).to(p.dtype)

    new_params = tree_map(upd, params, new_m, new_v)
    return new_params, OptState(new_m, new_v, count), {"grad_norm": gn,
                                                      "lr": lr}
