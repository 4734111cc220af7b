"""Kernel 1's (``csrc/sw_forward.cu``) share of its roofline, in %: the
least time of the traced calls (``portbench.roofline.sw_bound_s`` from
each call's true lengths) over the kernel's device time in the trace."""
from portbench import roofline

KERNEL = "sw_forward_kernel"


def probe(ctx):
    import torch

    from repro_torch.kernels.sw import ops
    orig = ops.gotoh_forward
    acc = {"bound_s": torch.zeros((), dtype=torch.float64,
                                  device=ctx.device)}

    def counted(a, b, lens, sub, **kw):
        if ctx.profiling:
            lens64 = lens.to(torch.float64)
            la, lb = lens64[:, 0], lens64[:, 1]
            target = b.shape[1] if b.stride(0) == 0 else lb.sum()
            acc["bound_s"] += roofline.sw_bound_s(la, lb, target)
        return orig(a, b, lens, sub, **kw)

    ops.gotoh_forward = counted
    ctx.restores.append(lambda: setattr(ops, "gotoh_forward", orig))
    ctx.probes["k1"] = acc


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    t = p.seconds(lambda k: KERNEL in k)
    if t <= 0:
        return None
    return 100.0 * float(ctx.probes["k1"]["bound_s"]) / t
