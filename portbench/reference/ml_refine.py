"""Plain reference of the ML-refinement job. Imports nothing of the
program.

A refinement is a chain of fits: the four models fitted on the start
tree, then one fit after every accepted interchange. The harness records
each fit's start and result as the program hands them on (the
``handoffs``); the reference follows that chain from the program's own
states and judges every link by what it determines:

* ``handoffs_bad``: links that do not follow from the one before: the
  model fits not on the start tree or not from the configuration's
  starting parameters, an interchange's fit not on a candidate of the
  tree before it, the result not the last fit's tree relabelled;
* ``start_q_gap``, ``start_blen``, ``start_bad``: the start tree (neighbor
  joining on the JC69 distances) replayed join by join on the
  reference's float64 distances, its lengths floored at 0 as the
  refinement takes them;
* ``ll_start``: the start tree's JC69 logL against the reference's;
* ``fit_gap``, the largest of three readings of the fitted state: every
  fitted logL, and the final one, against the reference's logL of the
  lengths and parameters the fit returned; the chosen model's BIC above
  the least, each BIC from the reference's logL of that model's fitted
  point, over the least's magnitude; for fits drawn from the seed in one
  refinement drawn from the seed, how far the fitted logL falls short of
  the reference's own fit (float64 Adam, the same steps) from the same
  start. The three are one number: the lower-precision control moves
  the first alone, a fit that stops short moves the last alone, and a
  wrong model choice the second alone;
* ``nni_gap``: in that refinement, at every interchange decision, how
  far the accepted candidate lies below the best candidate or below the
  acceptance threshold, or how far the best candidate lies above the
  threshold where the program stopped (the reference's float64 logL of
  every candidate).

Relative numbers are over the reference's |logL|.
"""
from __future__ import annotations

import numpy as np
import torch

from . import likelihood as lik
from . import tree


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool((a == b).all())


def _rel(a: float, ref: float) -> float:
    return abs(a - ref) / max(abs(ref), 1e-300)


class _Family:
    def __init__(self, rows: np.ndarray, device):
        pat, w = lik.compress(rows)
        self.rows = rows
        self.n = rows.shape[0]
        self.n_sites = float(w.sum())
        self.patterns = torch.from_numpy(pat).to(device)
        self.weights = torch.from_numpy(w).to(device)
        self.freqs = lik.empirical_freqs(pat, w)

    def ll(self, children, blen, order, root, model, params):
        with torch.no_grad():
            return float(lik.loglik(self.patterns, self.weights, children,
                                    blen, order, root, model, params))


def _links(rec, fam, nni_rounds):
    """The chain's decision points and the count of links that do not
    follow: returns (bad, decisions) with decisions a list of
    (state fit, chosen candidate index or None)."""
    n = fam.n
    hs = rec["handoffs"]
    bad = 0
    M = 2 * n - 1
    start_ch, start_bl = rec["start_children"], rec["start_blen"]
    order0 = np.arange(n, M)
    if len(hs) < len(lik.MODELS):
        return 1 + len(lik.MODELS), []
    for h, m in zip(hs, lik.MODELS):
        want = lik.init_params(m, fam.freqs)
        bad += int(h["model"] != m or not _same(h["children"], start_ch)
                   or not _same(h["blen0"], start_bl)
                   or not _same(h["order"], order0)
                   or h["root"] != 2 * n - 2
                   or np.asarray(h["params0"]).shape != want.shape
                   or not np.allclose(h["params0"], want, atol=1e-5,
                                      rtol=0))
    bics = {h["model"]: lik.bic(h["ll"], h["model"], n, fam.n_sites)
            for h in hs[:len(lik.MODELS)]}
    chosen = min(bics, key=bics.get)
    state = hs[lik.MODELS.index(chosen)]
    bad += int(rec["model"] != chosen)
    decisions = []
    for h in hs[len(lik.MODELS):]:
        cands = lik.nni_candidates(state["children"], state["blen"],
                                   state["order"], n)
        pick = next((k for k, (c, b, o) in enumerate(cands)
                     if _same(c, h["children"]) and _same(b, h["blen0"])
                     and _same(o, h["order"])), None)
        bad += int(pick is None or h["model"] != chosen
                   or not _same(h["params0"], state["params"]))
        decisions.append((state, pick))
        state = h
    if len(hs) - len(lik.MODELS) < nni_rounds:
        decisions.append((state, None))         # where the program stopped
    ch, bl, rt = lik.renumber(state["children"], state["blen"], 2 * n - 2,
                              state["order"], n)
    bad += int(not _same(ch, rec["children"]) or not _same(bl, rec["blen"])
               or rt != rec["root"] or rec["logl_final"] != state["ll"]
               or rec["n_nni"] != len(hs) - len(lik.MODELS))
    return bad, decisions


def check(families, records, rng, check_cfg: dict, traffic: dict,
          device) -> dict:
    """``families``: the pool's aligned rows (host int8 arrays);
    ``records``: one dict a refinement (``family``, ``start_children``,
    ``start_blen``, ``handoffs``, and the result's ``children``, ``blen``,
    ``root``, ``model``, ``params``, ``logl_init``, ``logl_final``,
    ``n_nni``)."""
    fams = {}
    out = dict(handoffs_bad=0, start_bad=0, start_q_gap=0.0, start_blen=0.0,
               ll_start=0.0, fit_gap=0.0)
    links = []
    for rec in records:
        f = rec["family"]
        if f not in fams:
            fams[f] = _Family(np.asarray(families[f]), device)
        fam = fams[f]
        n = fam.n
        bad, decisions = _links(rec, fam, int(traffic["nni_rounds"]))
        out["handoffs_bad"] += bad
        links.append(decisions)
        D = tree.distances(torch.from_numpy(fam.rows).to(device),
                           n_chars=5, gap_code=5, dtype=torch.float64)
        q_gap, blen_err, t_bad = tree.nj_replay(
            D, rec["start_children"], rec["start_blen"], 2 * n - 2,
            floor=True)
        del D
        out["start_bad"] += t_bad
        out["start_q_gap"] = max(out["start_q_gap"], q_gap)
        out["start_blen"] = max(out["start_blen"], blen_err)
        order0 = np.arange(n, 2 * n - 1)
        ll0 = fam.ll(rec["start_children"], rec["start_blen"], order0,
                     2 * n - 2, "jc69", np.zeros(0))
        out["ll_start"] = max(out["ll_start"], _rel(rec["logl_init"], ll0))
        refs = {}
        for h in rec["handoffs"]:
            ref = fam.ll(h["children"], h["blen"], h["order"], h["root"],
                         h["model"], h["params"])
            out["fit_gap"] = max(out["fit_gap"], _rel(h["ll"], ref))
            refs.setdefault(h["model"], ref)
        final = fam.ll(rec["children"], rec["blen"],
                       np.arange(n, 2 * n - 1), rec["root"], rec["model"],
                       rec["params"])
        out["fit_gap"] = max(out["fit_gap"], _rel(rec["logl_final"], final))
        if len(refs) == len(lik.MODELS) and rec["model"] in refs:
            bics = {m: lik.bic(v, m, n, fam.n_sites) for m, v in refs.items()}
            least = min(bics.values())
            out["fit_gap"] = max(out["fit_gap"], (
                bics[rec["model"]] - least) / max(abs(least), 1e-300))
        else:
            out["handoffs_bad"] += 1

    k = int(rng.integers(len(records)))
    rec, fam = records[k], fams[records[k]["family"]]
    hs = rec["handoffs"]
    n_fits = min(int(check_cfg["fits"]), len(hs))
    short = 0.0
    for i in sorted(rng.choice(len(hs), size=n_fits, replace=False)):
        h = hs[int(i)]
        _, _, ll = lik.fit(fam.patterns, fam.weights, h["children"],
                           h["order"], h["root"], h["blen0"], h["params0"],
                           h["model"], steps=int(traffic["ml_steps"]),
                           lr=float(traffic["lr"]))
        short = max(short, (ll - h["ll"]) / max(abs(ll), 1e-300))
    out["fit_gap"] = max(out["fit_gap"], short)
    gain = float(traffic["min_gain"])
    nni_gap = 0.0
    for state, pick in links[k]:
        cands = lik.nni_candidates(state["children"], state["blen"],
                                   state["order"], fam.n)
        if not cands:
            continue
        lls = np.array([fam.ll(c, b, o, state["root"], state["model"],
                               state["params"]) for c, b, o in cands])
        best = float(lls.max())
        scale = max(abs(best), 1e-300)
        if pick is None:
            nni_gap = max(nni_gap, (best - (state["ll"] + gain)) / scale)
        else:
            nni_gap = max(nni_gap, (best - lls[pick]) / scale,
                          (state["ll"] + gain - lls[pick]) / scale)
    out["nni_gap"] = nni_gap
    return out


def control(families, jobs, traffic: dict, precision: str, device) -> list:
    """Refinements by the reference in the program's place, each stage a
    precision below the configuration's: the start tree by neighbor
    joining on JC69 distances in bfloat16 (float32 stated), the fits and
    the candidates' logL in float32 with products in TF32 (``precision``
    ``tf32``; float32 with TF32 off stated); ``jobs`` lists the families
    refined, in order."""
    out = []
    for f in jobs:
        rows = np.asarray(families[f])
        fam = _Family(rows, device)
        D = tree.distances(torch.from_numpy(rows).to(device), n_chars=5,
                           gap_code=5, dtype=tree.LOWER["bf16"])
        ch, bl, root = tree.nj(D)
        res = lik.refine(fam.patterns, fam.weights, fam.n_sites, ch,
                         bl.astype(np.float32), root,
                         steps=int(traffic["ml_steps"]),
                         lr=float(traffic["lr"]),
                         nni_rounds=int(traffic["nni_rounds"]),
                         min_gain=float(traffic["min_gain"]),
                         dtype=torch.float32, tf32=precision == "tf32")
        res.update(family=f, start_children=res["handoffs"][0]["children"],
                   start_blen=res["handoffs"][0]["blen0"])
        out.append(res)
    return out
