"""repro_torch.obs — tracing, metrics, and memory gauges for the port.

  metrics   process-wide registry of counters / gauges / histograms with
            a Prometheus text renderer and JSON snapshots
  trace     nestable ``span()`` context managers -> Chrome-trace JSON,
            with per-request trace-ID propagation and an optional
            ``torch.profiler`` bridge
  runtime   device/host memory gauges sampled at root-span boundaries
  export    the ``--trace-out`` / ``--metrics-out`` launcher flags
"""
from . import export, metrics, runtime, trace  # noqa: F401
