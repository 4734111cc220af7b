"""Seconds of the ``map1`` span (k-mer chaining, the segment and
fallback DPs: kernel 1) a job (the jobs the profiler left alone)."""


def read(ctx):
    if not ctx.span_jobs:
        return None
    return sum(d for n, d in ctx.spans if n == "map1") / ctx.span_jobs
