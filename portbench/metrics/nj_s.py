"""Seconds of the ``tree.nj`` span (dense neighbor joining on the card)
a job (the jobs the profiler left alone)."""


def read(ctx):
    if not ctx.span_jobs:
        return None
    return sum(d for n, d in ctx.spans if n == "tree.nj") / ctx.span_jobs
