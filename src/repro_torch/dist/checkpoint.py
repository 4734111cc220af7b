"""Crash-safe persistence: one-file npz writes and step checkpoints.

``atomic_save_npz`` is the durability primitive (the search index
persists through it). ``CheckpointManager`` keeps one ``step_<N>.npz``
file per step holding the state's leaves as ``leaf_0, leaf_1, ...`` in
the reference's flatten order (a dict's values by sorted key, lists and
tuples in order), so a checkpoint the JAX package wrote restores here and
the other way round. Every write goes through ``atomic_save_npz``.
Retention keeps the newest ``keep`` steps. ``restore`` walks newest-to-oldest past
unreadable or mismatched files. Given a ``mesh``, only its rank 0 writes,
and every rank waits at a barrier until the write is done (all ranks
read the same files). A sharded tree (DTensor leaves, ``models/
sharding_plan``) is saved as its full arrays: each DTensor leaf is
gathered (``full_tensor``, a collective every rank joins) and rank 0
writes the same ``step_*.npz`` as an unsharded run; ``restore(like,
shardings)`` distributes each leaf by ``shardings`` (a ``sharding_plan.
Shardings`` of the tree's specs) or, without it, by the placements of
``like``'s leaf, so a checkpoint saved on one mesh restores on a mesh of
another shape, or on none.
"""
from __future__ import annotations

import os
import time
import uuid
import warnings
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..obs import metrics as _obs

_PREFIX = "step_"
_SUFFIX = ".npz"

_H_WRITE = _obs.histogram("repro_checkpoint_write_seconds",
                          "serialize + atomic replace per checkpoint")
_C_WRITES = _obs.counter("repro_checkpoint_writes_total",
                         "checkpoints written")
_C_BYTES = _obs.counter("repro_checkpoint_bytes_total",
                        "checkpoint bytes written")
_C_RESTORES = _obs.counter("repro_checkpoint_restores_total",
                           "successful checkpoint restores")


def atomic_save_npz(path, arrays: dict, *, _hook=None):
    """Crash-safe npz write: temp file in the target directory, then one
    ``os.replace``.

    ``_hook(label)`` is a fault-injection seam: it is called at
    ``save.serialize`` (nothing written yet), ``save.pre-replace`` (temp
    complete, final untouched) and ``save.post-replace`` (final replaced).
    A hook that raises models a crash at that point; the temp file is
    always cleaned up, the final file is either the old bytes or the new
    bytes, never a mix.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".tmp-{uuid.uuid4().hex}"
    try:
        if _hook is not None:
            _hook("save.serialize")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        if _hook is not None:
            _hook("save.pre-replace")
        os.replace(tmp, path)
        if _hook is not None:
            _hook("save.post-replace")
    finally:
        tmp.unlink(missing_ok=True)


def _leaves(tree) -> list:
    """Leaves in the reference's flatten order: dict values by sorted
    key, list/tuple items in order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _unflatten(like, it):
    """``like``'s structure with its leaves taken from ``it`` in flatten
    order; a torch leaf comes back as a tensor on its device, a DTensor
    leaf distributed as it is."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(item, it) for item in like]
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    host = next(it)
    if _dtensor(like):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(torch.from_numpy(host).to(like.device),
                                 like.device_mesh, like.placements,
                                 src_data_rank=None)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(host).to(like.device)
    return host


def _to_host(x) -> np.ndarray:
    if _dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.array(x)


def _plain(tree):
    """``tree`` with each DTensor leaf's local tensor (a template for
    ``_unflatten``: the structure and devices only)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_plain(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree.to_local() if _dtensor(tree) else tree


class CheckpointManager:
    def __init__(self, directory, keep: Optional[int] = None, *, mesh=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.mesh = mesh

    # ------------------------------------------------------------- inventory

    def _path(self, step: int) -> Path:
        return self.dir / f"{_PREFIX}{step:010d}{_SUFFIX}"

    def all_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob(f"{_PREFIX}*{_SUFFIX}"):
            try:
                steps.append(int(p.name[len(_PREFIX):-len(_SUFFIX)]))
            except ValueError:
                continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree):
        """Checkpoint ``tree`` as ``step`` (host copy, atomic write, then
        retention). On a mesh rank 0 writes, between two barriers: no rank
        reads the directory while it changes, so every rank sees the same
        steps."""
        if self.mesh is None:
            return self._write(step, [_to_host(x) for x in _leaves(tree)])
        # every rank gathers (a collective), rank 0 writes
        host = [_to_host(x) for x in _leaves(tree)]
        self.mesh.barrier()
        if self.mesh.rank == 0:
            self._write(step, host)
        self.mesh.barrier()

    def _write(self, step: int, host):
        t0 = time.perf_counter()
        path = self._path(step)
        atomic_save_npz(path, {f"leaf_{i}": x for i, x in enumerate(host)})
        _H_WRITE.observe(time.perf_counter() - t0)
        _C_WRITES.inc()
        _C_BYTES.inc(path.stat().st_size)
        self._gc()

    def _gc(self):
        if self.keep is None:
            return
        steps = self.all_steps()
        for s in steps[:max(len(steps) - self.keep, 0)]:
            try:
                self._path(s).unlink()
            except FileNotFoundError:
                pass

    # --------------------------------------------------------------- restore

    def restore(self, like, shardings=None, step: Optional[int] = None):
        """Load into the structure of ``like``; returns ``(tree, step)``.

        With ``step=None`` the newest readable checkpoint wins; unreadable
        or structurally mismatched files are skipped with a warning.
        ``shardings`` (a ``sharding_plan.Shardings`` of ``like``'s
        structure) distributes each leaf by its spec (module doc).
        """
        leaves = _leaves(like)
        candidates = [step] if step is not None else self.all_steps()[::-1]
        for s in candidates:
            host = self._read(s, shapes=[tuple(x.shape) if hasattr(
                x, "shape") else np.shape(x) for x in leaves],
                              strict=step is not None)
            if host is None:
                continue
            _C_RESTORES.inc()
            if shardings is None:
                return _unflatten(like, iter(host)), s
            tree = _unflatten(_plain(like), iter(host))
            return shardings(tree), s
        raise FileNotFoundError(
            f"no restorable checkpoint in {self.dir} "
            f"(requested step={step}, present={self.all_steps()})")

    def _read(self, step: int, *, shapes, strict: bool):
        path = self._path(step)
        try:
            with np.load(path) as z:
                host = [z[f"leaf_{i}"] for i in range(len(z.files))]
        except Exception as e:
            if strict:
                raise
            warnings.warn(f"skipping unreadable checkpoint {path}: {e!r}")
            return None
        msg = None
        if len(host) != len(shapes):
            msg = (f"checkpoint {path} has {len(host)} leaves, "
                   f"restore target has {len(shapes)}")
        else:
            for i, (h, shp) in enumerate(zip(host, shapes)):
                if tuple(h.shape) != tuple(shp):
                    msg = (f"checkpoint {path} leaf {i} has shape {h.shape}, "
                           f"restore target expects {shp}")
                    break
        if msg is not None:
            if strict:
                raise ValueError(msg)
            warnings.warn("skipping: " + msg)
            return None
        return host
