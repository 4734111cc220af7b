"""Local meshes over a ``torch.distributed`` world.

Importing this module never touches the process group: the world is made
and the mesh built inside functions only.

  ``world(device)``          a context that makes sure a process group
                             exists: it uses the caller's group when one
                             is initialized (a ``torchrun`` script, a test,
                             ``chip_smoke.py``); else it initializes one
                             from the ``torchrun`` environment when
                             ``WORLD_SIZE`` is set, or a world of one
                             (``HashStore``, rank 0) otherwise, and
                             destroys what it made on exit
  ``make_local_mesh``        a (data, model) ``dist.sharding.Mesh`` over
                             the world; D·M must equal its size
  ``mesh_from_arg``          the CLI ``--mesh DxM`` string -> a mesh
                             (``None``: the world's size x 1)
  ``make_production_mesh``   the production (data, model) mesh of 16 x 16
                             = 256 ranks, or (pod, data, model) of
                             2 x 16 x 16 = 512, over the initialized world
                             (a ``torchrun`` world or the dry run's fake
                             one, ``launch/dryrun.py``)

The backend a launcher initializes is ``nccl`` on ``cuda`` and ``gloo``
on ``cpu``; nothing switches backend quietly. NCCL refuses two ranks on
one card, so a caller that puts ranks on a shared card initializes
``gloo`` itself.
"""
from __future__ import annotations

import contextlib
import os
from datetime import timedelta

import torch
import torch.distributed as dist

# a collective that waits longer than this raises instead of hanging
TIMEOUT = timedelta(seconds=600)


def backend_for(device) -> str:
    """The backend a launcher initializes for ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError(
                "--dist on cuda needs the NCCL backend, which this PyTorch "
                "build lacks; run with --device cpu (gloo) or initialize "
                "a process group yourself")
        return "nccl"
    return "gloo"


def rank_device(device) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK % device_count()`` (made the
    current card, so ``"cuda"`` means it from here on) or ``cpu``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    from ..device import resolve_device
    resolve_device(dev)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    out = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(out)
    return out


@contextlib.contextmanager
def world(device):
    """A process group for the block (see the module docstring)."""
    if dist.is_initialized():
        yield
        return
    backend = backend_for(device)
    if "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            rank_device(device)
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    try:
        yield
    finally:
        if dist.is_initialized():       # a fault may have left it already
            dist.destroy_process_group()


def make_local_mesh(shape=(1, 1), axes=("data", "model"), *,
                    device="cuda"):
    """A mesh of ``shape`` over the initialized world's ranks, on each
    rank's ``device``; the world's size must be the product of
    ``shape``."""
    from ..dist.sharding import Mesh
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialized process "
                           "group (repro_torch.launch.mesh.world)")
    shape = tuple(int(s) for s in shape)
    return Mesh(shape, tuple(axes), None, dist.get_rank(),
                dist.get_world_size(), rank_device(device))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh over the initialized world: (data, model) of
    16 x 16 = 256 ranks, or with ``multi_pod`` (pod, data, model) of
    2 x 16 x 16 = 512 (the reference's is a 16x16 v5e pod, or two). The
    world must have exactly that many ranks; a world of another size
    raises, naming both counts."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, the world has {have} -- run "
            f"under launch/dryrun.py, which makes a fake world of {n}")
    from ..dist.sharding import Mesh
    dev = torch.device(device)
    return Mesh(shape, axes, None, dist.get_rank(), n,
                torch.device(dev.type) if dev.type == "cpu"
                else torch.device(dev.type, 0))


def mesh_from_arg(arg=None, *, device="cuda"):
    """CLI ``--mesh DxM`` string -> a (data, model) mesh over the world.

    ``None`` (flag omitted) uses every rank x 1. Shared by the
    ``msa_run`` / ``search_run`` / ``tree_run`` launchers.
    """
    if arg:
        try:
            d, m = (int(x) for x in arg.split("x"))
        except ValueError:
            raise ValueError(f"--mesh expects DxM (e.g. 4x1), got {arg!r}")
    else:
        d, m = dist.get_world_size() if dist.is_initialized() else 1, 1
    return make_local_mesh((d, m), ("data", "model"), device=device)


@contextlib.contextmanager
def run_on_mesh(on: bool, arg, device):
    """The launchers' mesh for the block: ``None`` unless ``on``, else
    ``mesh_from_arg(arg)`` over the world (``world`` makes one if no
    process group exists)."""
    if not on:
        yield None
        return
    with world(device):
        yield mesh_from_arg(arg, device=device)
