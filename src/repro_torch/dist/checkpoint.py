"""Crash-safe single-file persistence.

Only ``atomic_save_npz`` of ``repro.dist.checkpoint`` is ported (the
search index persists through it); the checkpoint manager belongs to the
distributed runtime, ROADMAP.md §1 item 11.
"""
from __future__ import annotations

import os
import uuid
from pathlib import Path

import numpy as np


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
