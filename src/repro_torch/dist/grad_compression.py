"""Quantized gradient reduction with error feedback.

The data-parallel mean is the bandwidth bill of distributed training;
int8 quantization cuts it 4x against f32. The residual each step is
carried in an error-feedback buffer and added back before the next
quantization, so the bias of rounding does not accumulate (1-bit-Adam /
EF-SGD style — the compressed mean converges to the true mean over
steps).

Protocol per tensor, over a process group (the reference's axis name;
``None``: the world):
  scale = max over ranks of max|g + ef| / 127   (one MAX all_reduce)
  q     = round((g + ef) / scale)  int8
  mean  = sum over ranks of q * scale / n       (see below)
  ef'   = (g + ef) - q * scale                  (local residual, no comm)

Wire strategy for the sum: an int8 ``all_gather`` moves (n-1)·S bytes per
rank against ~8·S for a ring f32 all-reduce, so gathering int8 wins up to
``_GATHER_MAX`` ranks; above that an int32 SUM ``all_reduce``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_QMAX = 127.0
_GATHER_MAX = 8      # most ranks where an int8 all_gather beats f32


def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _leaves(tree) -> list:
    """The tensors of nested dicts / lists / tuples, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(like, it):
    """``like``'s structure with its leaves taken from the iterator."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(t, it) for t in like)
    return next(it)


def init_ef(tree):
    """Zero error-feedback buffers matching a gradient tree (f32)."""
    return _rebuild(tree, iter([torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device)
                                for g in _leaves(tree)]))


def compressed_psum_mean(g: torch.Tensor, group, ef: torch.Tensor):
    """One tensor: int8-quantized mean over the ranks. Returns
    ``(mean, new_ef)``."""
    v = g.to(torch.float32) + ef
    m = torch.max(torch.abs(v)).reshape(1) if v.numel() else \
        torch.zeros(1, device=v.device)
    n = _size(group)
    if n > 1:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(m[0] / _QMAX, min=1e-30)
    q = torch.clamp(torch.round(v / scale), -_QMAX, _QMAX).to(torch.int8)
    if n == 1:
        total = q.to(torch.int32)
    elif n <= _GATHER_MAX:
        # int8 stays int8 on the wire; accumulate locally in int32
        parts = [torch.empty_like(q) for _ in range(n)]
        dist.all_gather(parts, q.contiguous(), group=group)
        total = torch.stack(parts).to(torch.int32).sum(dim=0)
    else:
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    mean = total.to(torch.float32) * (scale / n)
    new_ef = v - q.to(torch.float32) * scale
    return mean.to(g.dtype), new_ef


def tree_compressed_psum_mean(grads, group, ef):
    """Whole-tree compressed mean. Returns ``(mean_tree, new_ef_tree)``."""
    pairs = [compressed_psum_mean(g, group, e)
             for g, e in zip(_leaves(grads), _leaves(ef))]
    return (_rebuild(grads, iter([m for m, _ in pairs])),
            _rebuild(grads, iter([e for _, e in pairs])))
