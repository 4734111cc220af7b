"""Device/host memory gauges, sampled at root-span boundaries.

``sample()`` refreshes:

  repro_device_live_bytes   ``torch.cuda.memory_allocated()`` (bytes held
                            by live CUDA tensors; 0 without a card)
  repro_host_peak_rss_bytes ``ru_maxrss`` of this process

Sampling is rate-limited (``MIN_INTERVAL`` seconds); ``trace.span`` calls
``maybe_sample()`` whenever a root span closes, so long-running
pipelines get a free memory timeline without any per-span cost.  torch is
read from ``sys.modules`` only — importing this module stays
dependency-free.
"""
from __future__ import annotations

import sys
import time

from . import metrics as _metrics

__all__ = ["sample", "maybe_sample", "MIN_INTERVAL"]

MIN_INTERVAL = 1.0

_G_DEVICE = _metrics.gauge(
    "repro_device_live_bytes", "bytes held by live CUDA tensors")
_G_RSS = _metrics.gauge(
    "repro_host_peak_rss_bytes", "peak resident set size of this process")

_last_sample = 0.0


def sample(force: bool = True) -> None:
    """Refresh memory gauges now (``force=False`` honours the rate limit)."""
    global _last_sample
    if not _metrics.REGISTRY.enabled:
        return
    now = time.monotonic()
    if not force and now - _last_sample < MIN_INTERVAL:
        return
    _last_sample = now
    torch = sys.modules.get("torch")   # never *trigger* the import
    if torch is not None and torch.cuda.is_available():
        _G_DEVICE.set(float(torch.cuda.memory_allocated()))
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    _G_RSS.set(float(ru) * 1024.0)  # linux reports KiB


def maybe_sample() -> None:
    sample(force=False)
