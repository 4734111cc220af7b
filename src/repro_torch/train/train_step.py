"""The training step on PyTorch: microbatched gradient accumulation, remat
and AdamW; the port of ``repro/train/train_step.py``.

The global batch is split into ``microbatches`` slices along its batch
axis (axis 1 of ``pos3``, as the reference's ``split_micro``) and a
Python loop runs each through the model and its backward pass, where the
reference scans them. Each layer is rematerialized (``cfg.remat``,
``models/transformer.py``), so one microbatch's activations are alive at a
time. Gradients accumulate in f32 in the leaves' ``.grad`` (the
reference's running sum, in the same order) and are divided by the count;
``optimizer.update`` then makes the new state. The step is a plain
function on tensors (no ``torch.compile``); its metrics stay 0-d tensors
on the device until the caller reads them.

On a mesh (parameters and optimizer moments placed by
``sharding_plan``, ``shard_fns`` its ``make_shard_fns``, a batch of
DTensors) the same step runs each rank's share: the loss is this data
rank's sum of token losses over the global token count (the shares add
up to the reference's mean, and their gradients to its gradient, which
the backward pass reduce-scatters into each leaf's own placements), the
logits' vocabulary split over the model axis enters a cross entropy
whose max, sum of exponentials and gold logit are reduced over that
axis, and a microbatch is the reference's: rows [k·B/μ, (k+1)·B/μ) of the
global batch, split over the data axes. The metrics are global.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch

from ..models.transformer import apply_model, init_params
from . import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.OptState
    step: torch.Tensor


def cross_entropy(logits, labels, ignore_id: int = -1):
    """logits (B, S, V) f32, labels (B, S) integers; the mean over the
    labels that are not ``ignore_id``."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore_id).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _cross_entropy_dist(logits, labels, sf, shift: bool,
                        ignore_id: int = -1):
    """``cross_entropy`` of DTensor logits (B, S, V) and labels (B, S) on
    a mesh, next-token shifted when ``shift``: this data rank's share of
    the mean over the global batch's labels."""
    from ..models import sharding_plan as sp
    lg, lab = logits.to_local(), labels.to_local()
    if shift:
        lg, lab = lg[:, :-1], lab[:, 1:]
    names = logits.device_mesh.mesh_dim_names
    vs = logits.placements[names.index("model")].is_shard()
    if vs:
        v0, V_l = sp.local_offset(logits, 2), lg.shape[-1]
        mx = sp.all_reduce(sf, lg.detach().amax(-1), "max", ["model"])
        se = sp.psum_model(sf, torch.exp(lg - mx[..., None]).sum(-1),
                           grad_partial=False)
        t = lab.clamp(min=0).long() - v0
        ok = (t >= 0) & (t < V_l)
        gold = torch.gather(lg, -1, t.clamp(0, V_l - 1)[..., None])[..., 0]
        gold = sp.psum_model(sf, gold * ok, grad_partial=False)
        nll = mx + torch.log(se) - gold
    else:
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, lab.clamp(min=0).long()[..., None])[
            ..., 0]
        nll = logz - gold
    mask = (lab != ignore_id).float()
    count = sp.all_reduce(sf, torch.sum(mask),
                          "sum", sp._dp_axes(sf.mesh) if sf.batch_split
                          else ())
    return torch.sum(nll * mask) / torch.clamp(count, min=1.0)


def loss_fn(params, cfg, batch, shard_fns=None, aux_weight: float = 0.01,
            compute_dtype=torch.bfloat16):
    """-> (loss + aux_weight · aux, (loss, aux)): next-token labels for a
    causal model, the labels as they are for an encoder. On a mesh the
    three are this data rank's shares (module doc)."""
    logits, _, aux = apply_model(params, cfg, batch, shard_fns=shard_fns,
                                 compute_dtype=compute_dtype)
    if _dtensor(logits):
        loss = _cross_entropy_dist(logits, batch["labels"], shard_fns,
                                   cfg.causal)
        return loss + aux_weight * aux, (loss, aux)
    if cfg.causal:
        logits = logits[:, :-1]
        labels = batch["labels"][:, 1:]
    else:
        labels = batch["labels"]
    loss = cross_entropy(logits, labels)
    return loss + aux_weight * aux, (loss, aux)


def split_micro(name: str, x, microbatches: int):
    """``x`` in ``microbatches`` slices of its batch axis (axis 1 of
    ``pos3``, which is (3, B, S))."""
    axis = 1 if name == "pos3" else 0
    b = x.shape[axis]
    if b % microbatches:
        raise ValueError(f"batch {b} of {name!r} does not split into "
                         f"{microbatches} microbatches")
    return torch.split(x, b // microbatches, dim=axis)


def _dtensor(x) -> bool:
    from ..models.sharding_plan import _is_dtensor
    return _is_dtensor(x)


def _micro_dist(batch, microbatches: int):
    """The reference's microbatches of a batch of DTensors: slice k holds
    global rows [k·B/μ, (k+1)·B/μ), placed as the batch is (the batch is
    gathered once, a few integers a token)."""
    if microbatches == 1:
        return [batch]
    from torch.distributed.tensor import distribute_tensor
    for k, v in batch.items():
        axis = 1 if k == "pos3" else 0
        rows = v.shape[axis] // microbatches
        split = [v.device_mesh.size(i) for i, p in enumerate(v.placements)
                 if p.is_shard(axis)]
        if split and rows % math.prod(split):
            raise ValueError(f"a microbatch of {rows} rows of {k!r} does "
                             f"not split over the data axes ({split})")
    parts = {k: split_micro(k, v.full_tensor(), microbatches)
             for k, v in batch.items()}
    return [{k: distribute_tensor(parts[k][i], v.device_mesh, v.placements,
                                  src_data_rank=None)
             for k, v in batch.items()} for i in range(microbatches)]


def make_train_step(cfg, adamw: opt.AdamWConfig, *, microbatches: int = 1,
                    shard_fns=None, grad_shardings=None,
                    compute_dtype=torch.bfloat16):
    """-> train_step(state, batch) -> (state, metrics).

    batch: ``tokens`` (B, S) or ``embeds`` (B, S, D), ``labels`` (B, S),
    optional ``positions`` and ``pos3``. metrics: ``loss`` and ``aux``
    (means over the microbatches), ``grad_norm`` and ``lr``.
    ``shard_fns`` and ``grad_shardings`` (a
    ``sharding_plan.Shardings`` of the parameters' specs, which the
    accumulated gradients are placed by) are the reference's: they matter
    on a mesh (module doc).
    """

    def train_step(state: TrainState, batch: Dict[str, Any]):
        live = [p.detach().requires_grad_()
                for p in opt.tree_leaves(state.params)]
        params = opt.tree_unflatten(state.params, live)
        on_mesh = _dtensor(live[0])
        if on_mesh:
            micro = _micro_dist(batch, microbatches)
        else:
            micro = [dict(zip(batch, parts)) for parts in zip(
                *(split_micro(k, v, microbatches)
                  for k, v in batch.items()))]
        lsum = asum = 0.0
        for mb in micro:
            with torch.enable_grad():
                total, (ce, aux) = loss_fn(params, cfg, mb, shard_fns,
                                           compute_dtype=compute_dtype)
                total.backward()
            lsum = lsum + ce.detach()
            asum = asum + aux.detach()
        grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                 else p.grad for p in live]
        if microbatches > 1:
            for g in grads:
                g.div_(microbatches)
        if grad_shardings is not None:
            grads = _place(grads, grad_shardings)
        sums = {"loss": lsum, "aux": asum}
        if on_mesh:
            from ..models import sharding_plan as sp
            axes = sp._dp_axes(shard_fns.mesh) if shard_fns.batch_split \
                else ()
            sums = {k: sp.all_reduce(shard_fns, v, "sum", axes)
                    for k, v in sums.items()}
        new_params, opt_state, om = opt.update(
            state.params, opt.tree_unflatten(state.params, grads), state.opt,
            adamw)
        if on_mesh:
            om = {k: v.full_tensor() if _dtensor(v) else v
                  for k, v in om.items()}
        metrics = {"loss": sums["loss"] / microbatches,
                   "aux": sums["aux"] / microbatches, **om}
        return TrainState(new_params, opt_state, state.step + 1), metrics

    return train_step


def _place(grads, shardings):
    """Each gradient in its ``Shardings`` spec's placements."""
    from ..models import sharding_plan as sp
    specs = sp._leaves(shardings.specs)
    out = []
    for g, spec in zip(grads, specs):
        pl = sp.placements(shardings.mesh, spec, g.ndim)
        if _dtensor(g) and tuple(g.placements) != tuple(pl):
            g = g.redistribute(g.device_mesh, pl)
        out.append(g)
    return out


def init_state(cfg, seed: int = 0, *, device="cuda",
               dtype=torch.float32) -> TrainState:
    """Random f32 master weights (``init_params``, a ``torch.Generator``
    seeded ``seed``), zero Adam moments and step 0."""
    params = init_params(cfg, seed, device=device, dtype=dtype)
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32,
                                  device=opt.tree_leaves(params)[0].device))
