"""The main path as a job: ``center_star_msa`` (encode, center, map1,
assemble), ``sp_score.avg_sp`` and ``TreeEngine(backend="dense")``,
which is ``msa_run --method kmer --tree nj`` without its file writes.

Each job aligns one family of the pool (job j takes family j mod pool),
given as strings, as the launcher reads them.
"""
from __future__ import annotations

import numpy as np

from ..reference import msa_nj as reference
from ..traffic import sim

UNITS = "seqs"


def setup(ctx) -> dict:
    tr = ctx.traffic
    fams = sim.families(ctx.config, tr["n_seqs"], tr["pool"], ctx.seed)
    import torch

    from repro_torch.core import sp_score
    from repro_torch.core.msa import MSAConfig, center_star_msa
    from repro_torch.phylo import TreeEngine
    m = ctx.config["msa"]
    cfg = MSAConfig(alphabet="dna", method=m["method"], k=m["k"],
                    match=m["match"], mismatch=m["mismatch"],
                    gap_open=m["gap_open"], gap_extend=m["gap_extend"],
                    max_seg=m["max_seg"], max_anchors=m["max_anchors"],
                    center=m["center"], backend="auto")
    engine = TreeEngine(gap_code=5, n_chars=5, correct=True,
                        backend="dense", cluster_threshold=64,
                        device=ctx.device)

    def job(seqs):
        res = center_star_msa(seqs, cfg, device=ctx.device)
        msa = torch.as_tensor(res.msa, device=ctx.device)
        sp = float(sp_score.avg_sp(msa, gap_code=5, n_chars=5))
        tree = engine.build(msa)
        return res, sp, tree

    return dict(families=[f.seqs for f in fams], job=job)


def warmup(state) -> None:
    state["job"](state["families"][0])


def run(state, j: int) -> dict:
    f = j % len(state["families"])
    res, sp, tree = state["job"](state["families"][f])
    return dict(family=f, msa=res.msa, center=int(res.center_idx),
                width=int(res.width), n_fallback=int(res.n_fallback),
                sp=sp, children=tree.children, blen=tree.blen,
                root=int(tree.root), units=len(res.msa))


def release(state) -> None:
    """Drop the program's objects; the inputs stay for the reference."""
    state.pop("job", None)


def end_to_end(records, window_s: float) -> dict:
    seqs = sum(r["units"] for r in records)
    return {"msa_seqs_per_s": seqs / window_s}


def check(state, records, rng, ctx) -> dict:
    return reference.check(state["families"], records, rng,
                           ctx.config["msa"], ctx.check, ctx.device)


def control(state, records, precision: str, ctx) -> list:
    return reference.control(records, precision, ctx.device)
