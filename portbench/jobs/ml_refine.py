"""ML refinement as a job: ``TreeEngine(refine="ml", backend="auto")``
at ``tree_run --refine ml``'s defaults (model auto, 150 Adam steps a
fit, 8 NNI rounds), on the aligned rows of one family of the pool (job j
takes family j mod pool), handed over as ``tree_run`` hands them.

The harness records every fit's start and result as the refinement
hands them on (``repro_torch.phylo.ml._fit`` wrapped: the same call, its
arguments and results copied to the host), so that the reference can
follow the chain.
"""
from __future__ import annotations

import numpy as np

from ..reference import ml_refine as reference
from ..reference.align import encode
from ..traffic import sim

UNITS = "refinements"


def _rows(fam) -> np.ndarray:
    widths = {len(s) for s in fam.seqs}
    if len(widths) != 1:
        raise ValueError("the ML traffic needs aligned rows: a family "
                         "simulated without indels")
    return np.stack([encode(s) for s in fam.seqs])


def setup(ctx) -> dict:
    tr = ctx.traffic
    fams = sim.families(ctx.config, tr["n_leaves"], tr["pool"], ctx.seed)
    import torch

    from repro_torch.phylo import TreeEngine
    from repro_torch.phylo import ml as ml_mod

    log: list = []
    orig = ml_mod._fit

    def recorded_fit(patterns, weights, children, order, root, blen0,
                     params0, **kw):
        bl, pr, ll = orig(patterns, weights, children, order, root, blen0,
                          params0, **kw)
        log.append(dict(children=np.array(children), order=np.array(order),
                        root=int(root), blen0=np.array(ml_mod._host(blen0)),
                        params0=np.array(ml_mod._host(params0)),
                        model=kw["model"], blen=bl.cpu().numpy(),
                        params=pr.cpu().numpy(), ll=float(ll)))
        return bl, pr, ll

    ml_mod._fit = recorded_fit

    def engine(steps, rounds):
        return TreeEngine(gap_code=5, n_chars=5, correct=True,
                          backend="auto", cluster_threshold=64,
                          row_block=128, target_cluster=64, seed=0,
                          refine="ml", model="auto", ml_steps=steps,
                          nni_rounds=rounds, device=ctx.device)

    def job(rows, eng):
        log.clear()
        res = eng.build(torch.from_numpy(rows).to(ctx.device))
        return res, list(log)

    return dict(rows=[_rows(f) for f in fams], job=job,
                engine=engine(int(tr["ml_steps"]), int(tr["nni_rounds"])),
                warm=engine(3, 1),
                restore=lambda: setattr(ml_mod, "_fit", orig))


def warmup(state) -> None:
    state["job"](state["rows"][0], state["warm"])


def run(state, j: int) -> dict:
    f = j % len(state["rows"])
    res, hs = state["job"](state["rows"][f], state["engine"])
    return dict(family=f, handoffs=hs, start_children=hs[0]["children"],
                start_blen=hs[0]["blen0"], children=res.children,
                blen=res.blen, root=int(res.root), model=res.model,
                params=[h for h in hs if h["model"] == res.model][-1][
                    "params"],
                logl_init=float(res.logl["initial"]),
                logl_final=float(res.logl["final"]), n_nni=int(res.n_nni),
                units=1)


def release(state) -> None:
    """Drop the program's objects and unwrap its fit; the inputs stay for
    the reference."""
    for key in ("job", "engine", "warm"):
        state.pop(key, None)
    state.pop("restore")()


def end_to_end(records, window_s: float) -> dict:
    return {"ml_refine_s": window_s / len(records)}


def check(state, records, rng, ctx) -> dict:
    return reference.check(state["rows"], records, rng, ctx.check,
                           ctx.traffic, ctx.device)


def control(state, records, precision: str, ctx) -> list:
    return reference.control(state["rows"], [r["family"] for r in records],
                             ctx.traffic, precision, ctx.device)
