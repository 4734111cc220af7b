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
"""
from __future__ import annotations

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


def loss_fn(params, cfg, batch, aux_weight: float = 0.01,
            compute_dtype=torch.bfloat16):
    """-> (loss + aux_weight · aux, (loss, aux)): next-token labels for a
    causal model, the labels as they are for an encoder."""
    logits, _, aux = apply_model(params, cfg, batch,
                                 compute_dtype=compute_dtype)
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


def make_train_step(cfg, adamw: opt.AdamWConfig, *, microbatches: int = 1,
                    compute_dtype=torch.bfloat16, grad_hook=None):
    """-> train_step(state, batch) -> (state, metrics).

    batch: ``tokens`` (B, S) or ``embeds`` (B, S, D), ``labels`` (B, S),
    optional ``positions`` and ``pos3``. metrics: ``loss`` and ``aux``
    (means over the microbatches), ``grad_norm`` and ``lr``.
    ``grad_hook(grads, metrics)``, where given, runs on the averaged
    gradients (a list in ``optimizer.tree_leaves`` order) and the loss
    sums before the update: the launcher's data-parallel mean.
    """

    def train_step(state: TrainState, batch: Dict[str, Any]):
        live = [p.detach().requires_grad_()
                for p in opt.tree_leaves(state.params)]
        params = opt.tree_unflatten(state.params, live)
        micro = [dict(zip(batch, parts)) for parts in zip(
            *(split_micro(k, v, microbatches) for k, v in batch.items()))]
        lsum = asum = 0.0
        for mb in micro:
            with torch.enable_grad():
                total, (ce, aux) = loss_fn(params, cfg, mb,
                                           compute_dtype=compute_dtype)
                total.backward()
            lsum = lsum + ce.detach()
            asum = asum + aux.detach()
        grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                 else p.grad for p in live]
        if microbatches > 1:
            for g in grads:
                g.div_(microbatches)
        sums = {"loss": lsum, "aux": asum}
        if grad_hook is not None:
            grad_hook(grads, sums)
        new_params, opt_state, om = opt.update(
            state.params, opt.tree_unflatten(state.params, grads), state.opt,
            adamw)
        metrics = {"loss": sums["loss"] / microbatches,
                   "aux": sums["aux"] / microbatches, **om}
        return TrainState(new_params, opt_state, state.step + 1), metrics

    return train_step


def init_state(cfg, seed: int = 0, *, device="cuda",
               dtype=torch.float32) -> TrainState:
    """Random f32 master weights (``init_params``, a ``torch.Generator``
    seeded ``seed``), zero Adam moments and step 0."""
    params = init_params(cfg, seed, device=device, dtype=dtype)
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32,
                                  device=opt.tree_leaves(params)[0].device))
