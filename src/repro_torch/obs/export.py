"""Shared ``--trace-out`` / ``--metrics-out`` plumbing for CLI runners."""
from __future__ import annotations

import argparse

from . import metrics, runtime, trace

__all__ = ["add_output_args", "write_outputs"]


def add_output_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("observability")
    g.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write Chrome-trace JSON of the run's span tree "
                        "(open in chrome://tracing or ui.perfetto.dev)")
    g.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write a JSON snapshot of the metrics registry")


def write_outputs(args: argparse.Namespace) -> None:
    """Honour the flags added by ``add_output_args`` after a run."""
    if getattr(args, "trace_out", None):
        trace.TRACER.write(args.trace_out)
        print(f"trace   -> {args.trace_out}")
    if getattr(args, "metrics_out", None):
        runtime.sample()
        metrics.REGISTRY.write_json(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
