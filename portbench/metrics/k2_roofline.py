"""Kernel 2's (``csrc/match_valid.cu``) share of its roofline, in %: the
least time of the traced calls (``portbench.roofline.match_valid_bound_s``,
distinct pairs for a symmetric call) over the kernel's device time."""
import re

from portbench import roofline

KERNEL = re.compile(r"\b(tc|simd|skinny)_kernel\b")


def probe(ctx):
    from repro_torch.kernels.distance import ops
    orig = ops.match_valid
    acc = {"bound_s": 0.0}

    def counted(msa_a, msa_b=None, **kw):
        if ctx.profiling:
            N, L = msa_a.shape
            M = N if msa_b is None else msa_b.shape[0]
            acc["bound_s"] += roofline.match_valid_bound_s(
                N, M, L, msa_b is None)
        return orig(msa_a, msa_b, **kw)

    ops.match_valid = counted
    ctx.restores.append(lambda: setattr(ops, "match_valid", orig))
    ctx.probes["k2"] = acc


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    t = p.seconds(lambda k: KERNEL.search(k) is not None)
    if t <= 0:
        return None
    return 100.0 * ctx.probes["k2"]["bound_s"] / t
