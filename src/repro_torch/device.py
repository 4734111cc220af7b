"""Device selection shared by the port's entry points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent — the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch path")
    return dev


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def on_device(device):
    """A context making ``device`` the thread's current card (a no-op on
    the CPU). The kernels launch on the current stream of their tensors'
    card, and the current card is per thread: a worker thread of a
    service enters this before it launches anything."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
