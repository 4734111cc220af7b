"""Seconds of the ``ml.fit`` spans (branch-length and model fits, one
CUDA graph replayed a step) a refinement (the refinements the
profiler left alone)."""


def read(ctx):
    if not ctx.span_jobs:
        return None
    return sum(d for n, d in ctx.spans if n == "ml.fit") / ctx.span_jobs
