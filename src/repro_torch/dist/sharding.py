"""Named-axis sharding over ``torch.distributed``: the port's mesh.

The reference is single-controller: one process, a ``jax.sharding.Mesh``
over its devices, ``shard_map`` to split work. The port is SPMD, one
process a rank, as a cluster (Spark's executors) runs: every rank runs
the same host program, and a ``Mesh`` names how the world's ranks tile a
``(data, model)`` grid. Rank r sits at ``np.unravel_index(r, shape)``, so
with the default axes its data index is ``r // M``; the M ranks that
share a data index compute the same shard, as the reference's replicas on
the model axis do.

Translation of the reference's collectives:

  in spec  P(data)             ``shard_rows``: this rank's block of rows
  in spec  P()                 ``broadcast``: rank 0's value everywhere
  ``lax.pmax``                 ``all_reduce_max`` (MAX over the world)
  out spec P(data)/P(None,data) ``gather_rows``: an ``all_gather`` over the
                               ranks, the blocks of model index 0 kept and
                               concatenated in data order

With ``gloo`` (the CPU backend, and the one a caller picks for ranks that
share a card) these take CUDA tensors as they are: gloo's ``broadcast``,
``all_reduce`` and ``all_gather`` accept them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[str, Tuple[str, ...], None]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid over the ranks of a process group.

    ``shape``'s product is the group's size; ``rank``/``size`` are this
    process's rank and the group's size; ``device`` is the rank's device
    (``cuda:LOCAL_RANK % device_count()`` on the card, ``cpu``).
    """
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")
        n = int(np.prod(self.shape))
        if n != self.size:
            raise ValueError(f"mesh {tuple(self.shape)} needs {n} ranks, "
                             f"the world has {self.size}")

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def coords(self) -> dict:
        """This rank's index along each axis."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(self.rank,
                                                          self.shape))))

    def block_index(self, axes: Axes) -> int:
        """This rank's block along ``axes`` (row-major over them)."""
        axes = _as_tuple(axes)
        if not axes:
            return 0
        c = self.coords()
        return int(np.ravel_multi_index(
            tuple(c[a] for a in axes),
            tuple(self.axis_sizes[a] for a in axes)))

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)

    def device_mesh(self):
        """The ``torch.distributed.DeviceMesh`` over the same ranks and
        axis names (made once a mesh, on its first call: every rank must
        make that call, since it creates a group an axis)."""
        dm = self.__dict__.get("_device_mesh")
        if dm is None:
            from torch.distributed.device_mesh import DeviceMesh
            ranks = torch.arange(self.size).reshape(self.shape)
            if self.group is not None:
                ranks = torch.tensor(dist.get_process_group_ranks(
                    self.group)).reshape(self.shape)
            dm = DeviceMesh(self.device.type, ranks,
                            mesh_dim_names=self.axis_names)
            object.__setattr__(self, "_device_mesh", dm)
        return dm


def _src(mesh: Mesh) -> int:
    """The global rank of the group's rank 0."""
    return 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)


def _as_tuple(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh: Mesh, axes: Axes) -> int:
    """Product of the mesh extents of ``axes`` (str, tuple, or None)."""
    n = 1
    for a in _as_tuple(axes):
        n *= mesh.axis_sizes[a]
    return n


def maybe(mesh: Mesh, dim: int, axes: Axes) -> Axes:
    """``axes`` if ``dim`` divides over them, else None (replicate)."""
    if axes is None or (not isinstance(axes, str) and len(axes) == 0):
        return None
    return axes if dim % axis_size(mesh, axes) == 0 else None


def first_fit(mesh: Mesh, dim: int, *candidates: Axes) -> Axes:
    """First candidate axis (group) that divides ``dim``; None replicates.

    ``first_fit(mesh, d, "model", ("pod", "data"), None)`` expresses a
    preference order in one call.
    """
    for cand in candidates:
        if cand is None:
            return None
        if dim % axis_size(mesh, cand) == 0:
            return cand
    return None


def row_spec(ndim: int, axis: Axes = "data") -> Tuple[Axes, ...]:
    """The split ``shard_rows`` makes: the leading dim over ``axis``, the
    rest whole (the reference's ``PartitionSpec(axis, None, ...)`` as a
    plain tuple)."""
    return (axis,) + (None,) * (ndim - 1)


def shard_rows(x, mesh: Mesh, axis: Axes = "data") -> torch.Tensor:
    """This rank's block of ``x``'s rows, split over ``axis``, on the
    rank's device.

    The leading extent must divide the axis size — pad first with
    ``mapreduce.pad_rows`` when it does not.
    """
    n = axis_size(mesh, axis)
    if x.shape[0] % n != 0:
        raise ValueError(
            f"leading dim {x.shape[0]} does not divide axis {axis!r} "
            f"(size {n}); pad with repro_torch.dist.mapreduce.pad_rows "
            "first")
    per = x.shape[0] // n
    b = mesh.block_index(axis)
    blk = x[b * per:(b + 1) * per]
    if not isinstance(blk, torch.Tensor):
        blk = torch.from_numpy(np.ascontiguousarray(blk))
    return blk.to(mesh.device)


def broadcast(x, mesh: Mesh) -> torch.Tensor:
    """``x`` on the rank's device, rank 0's value on every rank (Spark's
    broadcast variable)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    t = t.to(mesh.device).contiguous()
    if mesh.size > 1:
        dist.broadcast(t, src=_src(mesh), group=mesh.group)
    return t


def broadcast_object(obj, mesh: Mesh):
    """A host value (a center index, a tree) as rank 0 has it, on every
    rank: choices the ranks make on the host come from one rank, so no
    two ranks can differ."""
    if mesh.size == 1:
        return obj
    box = [obj]
    # NCCL moves the pickled bytes through the card; gloo on the host
    nccl = dist.get_backend(mesh.group) == "nccl"
    dist.broadcast_object_list(box, src=_src(mesh), group=mesh.group,
                               device=mesh.device if nccl else None)
    return box[0]


def all_reduce_max(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise max of ``t`` over every rank (the reference's
    ``lax.pmax``; model replicas hold equal values, so the world's max is
    the data axis's)."""
    t = t.contiguous()
    if mesh.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t


def gather_rows(t: torch.Tensor, mesh: Mesh, axis: Axes = "data",
                dim: int = 0) -> torch.Tensor:
    """The blocks of every rank along ``axis`` concatenated on ``dim`` in
    block order, on every rank: the reference's out spec ``P(axis)``
    (``dim=0``) or ``P(None, axis)`` (``dim=1``). Of the ranks that share
    a block (replicas on the other axes) the first one's copy is kept."""
    t = t.contiguous()
    if mesh.size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    first = {}
    for r in range(mesh.size):
        b = dataclasses.replace(mesh, rank=r).block_index(axis)
        first.setdefault(b, r)
    return torch.cat([parts[first[b]] for b in sorted(first)], dim=dim)
