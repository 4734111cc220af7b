"""Seconds of the ``ml.score`` spans (NNI candidates scored as forests)
a refinement (the refinements the
profiler left alone)."""


def read(ctx):
    if not ctx.span_jobs:
        return None
    return sum(d for n, d in ctx.spans if n == "ml.score") / ctx.span_jobs
