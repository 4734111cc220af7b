"""Plain reference of the main path's job: center-star MSA, SP score,
JC69 distances and neighbor joining. Imports nothing of the program.

``check`` judges what the timed path returned, job by job:

* ``rows_bad``: over every job, rows whose residues are not their input,
  all-gap columns, a width other than the rows', a center other than
  the configuration's (``first``: row 0);
* ``pair_score_gap``: for rows drawn from the seed in one job drawn from
  the seed, |score of the row's induced alignment with the center - the
  score the configuration's pairwise method gives the pair| (exact);
* ``sp_rel``: over every job, |average SP penalty - the exact one| over
  the exact one;
* ``tree_bad``, ``nj_q_gap``, ``nj_blen``: the drawn job's tree replayed
  join by join on the reference's float64 JC69 distances of its rows
  (``tree.nj_replay``).

``control`` puts the reference in the program's place at a lower
precision: the rows stay the program's (integers), the SP score, the
distances and the joins are computed in that precision.
"""
from __future__ import annotations

import numpy as np
import torch

from . import align, tree

GAP = 5
N_CHARS = 5


def _encoded(family_seqs):
    return [align.encode(s) for s in family_seqs]


def check(families, records, rng, msa_cfg: dict, check_cfg: dict,
          device) -> dict:
    """``families``: the pool of input sequence lists; ``records``: one
    dict a job (``family``, ``msa``, ``center``, ``width``, ``sp``,
    ``children``, ``blen``, ``root``)."""
    sub = align.sub_matrix(msa_cfg, GAP)
    encoded = {}
    rows_bad = 0
    sp_rel = 0.0
    exact_sp = {}
    for rec in records:
        f = rec["family"]
        if f not in encoded:
            encoded[f] = _encoded(families[f])
        seqs = encoded[f]
        msa = np.asarray(rec["msa"])
        if msa.shape != (len(seqs), rec["width"]):
            rows_bad += len(seqs)
            continue
        rows_bad += align.rows_bad(msa, seqs, GAP)
        rows_bad += align.empty_columns(msa, GAP)
        rows_bad += int(rec["center"] != 0)
        key = (f, msa.tobytes().__hash__())
        if key not in exact_sp:
            n = msa.shape[0]
            exact_sp[key] = tree.sp_total(msa, N_CHARS, GAP) / (
                n * (n - 1) / 2.0)
        ref = exact_sp[key]
        sp_rel = max(sp_rel, abs(rec["sp"] - ref) / max(abs(ref), 1e-300))

    pick = records[int(rng.integers(len(records)))]
    msa = np.asarray(pick["msa"])
    seqs = encoded[pick["family"]]
    if msa.shape != (len(seqs), pick["width"]):
        inf = float("inf")
        return {"rows_bad": rows_bad, "pair_score_gap": inf,
                "sp_rel": sp_rel, "tree_bad": 1, "nj_q_gap": inf,
                "nj_blen": inf}
    n_pairs = min(int(check_cfg["pairs"]), len(seqs) - 1)
    rows = 1 + rng.choice(len(seqs) - 1, size=n_pairs, replace=False)
    center = msa[0]
    got = np.array([align.induced_score(msa[r], center, sub, GAP,
                                        int(msa_cfg["gap_open"]),
                                        int(msa_cfg["gap_extend"]))
                    for r in rows])
    want = align.expected_scores([seqs[r] for r in rows], seqs[0],
                                    msa_cfg, sub, device)
    pair_gap = int(np.abs(got - want).max()) if n_pairs else 0

    D = tree.distances(torch.from_numpy(msa).to(device), n_chars=N_CHARS,
                       gap_code=GAP, dtype=torch.float64)
    q_gap, blen_err, tree_bad = tree.nj_replay(
        D, pick["children"], pick["blen"], pick["root"])
    del D
    return {"rows_bad": rows_bad, "pair_score_gap": pair_gap,
            "sp_rel": sp_rel, "tree_bad": tree_bad, "nj_q_gap": q_gap,
            "nj_blen": blen_err}


def control(records, precision: str, device) -> list:
    """The program's records with the SP score, distances and joins
    recomputed by the reference in ``precision`` (``tree.LOWER``)."""
    dtype = tree.LOWER[precision]
    out = []
    for rec in records:
        msa = torch.from_numpy(np.asarray(rec["msa"])).to(device)
        sp = tree.sp_lower(msa, N_CHARS, GAP, dtype)
        D = tree.distances(msa, n_chars=N_CHARS, gap_code=GAP, dtype=dtype)
        children, blen, root = tree.nj(D)
        out.append(dict(rec, sp=sp, children=children, blen=blen,
                        root=root))
    return out
