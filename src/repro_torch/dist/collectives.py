"""Overlap-friendly collectives over a process group.

The reference writes these inside ``shard_map`` with ``ppermute`` so XLA
can overlap the permute of step s+1 with the compute of step s. Here a
ring step is a ``dist.batch_isend_irecv`` of one shard to the next rank
and from the previous one, and the compute on the shard in hand runs
while that exchange is in flight. The reference's axis name is a process
group here (``group=None``: the world); ranks play the axis in group
order.

Gloo's point-to-point operations take host tensors only, so on a gloo
group a CUDA tensor is staged through a host copy for each exchange
(``_exchange``); NCCL exchanges device memory directly. Gloo has no
``reduce_scatter_tensor`` either: ``psum_scatter_mean`` is the ring of
the same exchanges on both backends.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(group=None) -> int:
    """Ranks of ``group`` (the world by default)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _peers(group):
    """(this rank's index in ``group``, its size, the global ranks of the
    next and previous members of the ring)."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)

    def glob(i):
        return i if group is None else dist.get_global_rank(group, i)
    return idx, n, glob((idx + 1) % n), glob((idx - 1) % n)


def _exchange(send: torch.Tensor, nxt: int, prv: int, group):
    """Start sending ``send`` to rank ``nxt`` and receiving a tensor like
    it from rank ``prv``; returns ``wait()`` -> the received tensor.

    On a gloo group a CUDA tensor goes through host copies (gloo's send
    and recv take host memory); the copy back to the device happens in
    ``wait``."""
    staged = (dist.get_backend(group) == "gloo"
              and send.device.type == "cuda")
    out = send.cpu() if staged else send.contiguous()
    buf = torch.empty_like(out)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, out, nxt, group),
        dist.P2POp(dist.irecv, buf, prv, group)])

    def wait() -> torch.Tensor:
        for r in reqs:
            r.wait()
        return buf.to(send.device) if staged else buf
    return wait


def ring_all_gather(x: torch.Tensor, group=None, *,
                    tiled_axis: int = 0) -> torch.Tensor:
    """All-gather via a ring of exchanges (bandwidth-optimal).

    Each rank contributes its shard; the result concatenates all shards
    along ``tiled_axis`` in rank order, the same on every rank.
    """
    n = axis_size(group)
    if n == 1:
        return x
    idx, n, nxt, prv = _peers(group)
    chunk = x.shape[tiled_axis]
    shape = list(x.shape)
    shape[tiled_axis] = chunk * n
    out = x.new_empty(shape)
    cur = x.contiguous()
    for s in range(n):
        pending = _exchange(cur, nxt, prv, group) if s < n - 1 else None
        src = (idx - s) % n                    # owner of the shard we hold
        out.narrow(tiled_axis, src * chunk, chunk).copy_(cur)
        if pending is not None:
            cur = pending()
    return out


def ag_matmul_overlap(x: torch.Tensor, w: torch.Tensor,
                      group=None) -> torch.Tensor:
    """``x @ all_gather(w)`` with the gather decomposed into a matmul ring.

    ``w`` is this rank's column shard (the reference's spec
    ``P(None, axis)``); ``x`` is the same on every rank. Each ring step
    multiplies the weight shard in hand into its column block of the
    output while the next shard is in flight. Returns the full
    (x.shape[0], w_cols * n) product on every rank.
    """
    n = axis_size(group)
    if n == 1:
        return torch.matmul(x, w)
    idx, n, nxt, prv = _peers(group)
    cols = w.shape[-1]
    dt = torch.result_type(x, w)
    out = x.new_empty(x.shape[:-1] + (cols * n,), dtype=dt)
    w_cur = w.contiguous()
    for s in range(n):
        pending = _exchange(w_cur, nxt, prv, group) if s < n - 1 else None
        src = (idx - s) % n
        out[..., src * cols:(src + 1) * cols] = torch.matmul(x, w_cur).to(dt)
        if pending is not None:
            w_cur = pending()
    return out


def psum_scatter_mean(x: torch.Tensor, group=None, *,
                      tiled_axis: int = 0) -> torch.Tensor:
    """Mean-reduce over the ranks, then keep only this rank's shard of
    ``tiled_axis`` (the reference's tiled ``psum_scatter`` / n).

    A ring reduce-scatter: at step s a rank passes on its running sum of
    one chunk and adds its own part to the chunk it receives; after n - 1
    steps rank r holds the whole sum of chunk r.
    """
    n = axis_size(group)
    if n == 1:
        return x.clone()
    idx, n, nxt, prv = _peers(group)
    chunk = x.shape[tiled_axis] // n
    if chunk * n != x.shape[tiled_axis]:
        raise ValueError(f"dim {tiled_axis} of size {x.shape[tiled_axis]} "
                         f"does not split over {n} ranks")

    def part(c):
        return x.narrow(tiled_axis, (c % n) * chunk, chunk)

    acc = part(idx - 1).contiguous()
    for s in range(n - 1):
        acc = _exchange(acc, nxt, prv, group)() + part(idx - s - 2)
    return acc / n
