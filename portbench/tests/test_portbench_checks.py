"""Each job's comparison at a tiny size on the CPU: a whole run of the
harness (the look for a card left out) gives ``correct`` true on the
port's CPU path, and false with a fault planted in the timed path or
with the reference put in the program's place at a lower precision.
No card is needed."""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from portbench import run as prun


def _tiny(name):
    cell = prun.Cell(name)
    if cell.kind == "msa_nj":
        cell.traffic.update(n_seqs=32, pool=2)
        cell.config["family"]["root_len"] = 240
        cell.check["pairs"] = 8
    else:
        cell.traffic.update(n_leaves=10, pool=2, ml_steps=8, nni_rounds=2)
        cell.config["family"].update(root_len=300, branch_sub=0.05)
        cell.check["fits"] = 2
    return cell


def _run(name, seed=2 ** 32 + 11):
    return prun.run(name, seed, 0.05, False, device="cpu", cell=_tiny(name))


# ----------------------------------------------------------- the main path

def _alter_a_residue(monkeypatch):
    from repro_torch.core import msa
    orig = msa.center_star_msa

    def faulty(*a, **kw):
        res = orig(*a, **kw)
        rows = res.msa.copy()
        col = int(np.flatnonzero(rows[3] != 5)[7])
        rows[3, col] = (rows[3, col] + 1) % 4
        return res._replace(msa=rows)

    monkeypatch.setattr(msa, "center_star_msa", faulty)


def _drop_half_the_rows(monkeypatch):
    from repro_torch.core import msa
    orig = msa.center_star_msa

    def faulty(seqs, *a, **kw):
        res = orig(seqs, *a, **kw)
        return res._replace(msa=res.msa[: len(res.msa) // 2])

    monkeypatch.setattr(msa, "center_star_msa", faulty)


def _perturb_a_branch(monkeypatch):
    from repro_torch.core import nj
    orig = nj.neighbor_joining

    def faulty(D, size):
        t = orig(D, size)
        blen = t.blen.clone()
        blen[size + 3, 0] += 0.2 * float(blen.abs().mean())
        return t._replace(blen=blen)

    monkeypatch.setattr(nj, "neighbor_joining", faulty)


def _join_the_wrong_pair(monkeypatch):
    from repro_torch.core import nj
    orig = nj.neighbor_joining

    def faulty(D, size):
        # the joins of the distances' negation: a valid tree, wrong picks
        return orig(D.max() - D, size)

    monkeypatch.setattr(nj, "neighbor_joining", faulty)


def _sp_in_half_precision(monkeypatch):
    from repro_torch.core import sp_score
    orig = sp_score.avg_sp

    def faulty(msa, **kw):
        return orig(msa, **kw).to(torch.bfloat16).to(torch.float32)

    monkeypatch.setattr(sp_score, "avg_sp", faulty)


MSA_FAULTS = {"a residue altered": (_alter_a_residue, "rows_bad"),
              "half the rows left out": (_drop_half_the_rows, "rows_bad"),
              "a branch length perturbed": (_perturb_a_branch, "nj_blen"),
              "the wrong pair joined": (_join_the_wrong_pair, "nj_q_gap"),
              "SP score in bfloat16": (_sp_in_half_precision, "sp_rel")}


def test_msa_nj_sound_run_is_correct():
    out = _run("rna16s.msa_nj")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


@pytest.mark.parametrize("fault", list(MSA_FAULTS))
def test_msa_nj_planted_fault_is_caught(monkeypatch, fault):
    plant, check = MSA_FAULTS[fault]
    plant(monkeypatch)
    out = _run("rna16s.msa_nj")
    assert not out["correct"]
    c = out["checks"][check]
    assert not c["value"] <= c["limit"], out["checks"]


def _control(name, precision):
    """The reference in the program's place at ``precision``, judged as
    the program's records are."""
    cell = _tiny(name)
    ctx = prun.Ctx(cell, 2 ** 31 + 3, "cpu")
    job = importlib.import_module(f"portbench.jobs.{cell.kind}")
    state = job.setup(ctx)
    records = [job.run(state, j) for j in range(2)]
    job.release(state)
    ctl = job.control(state, records, precision, ctx)
    return prun.judge(job.check(state, ctl, np.random.default_rng(1), ctx),
                      cell.limits)


def test_msa_nj_control_in_bfloat16_fails():
    checks = _control("rna16s.msa_nj", "bf16")
    assert not prun.passed(checks), checks
    for k in ("sp_rel", "nj_blen"):
        assert checks[k]["value"] > checks[k]["limit"], checks


# ------------------------------------------------------------ ML refinement

def _fit_returns_its_start(monkeypatch):
    from repro_torch.phylo import ml
    orig = ml._fit

    def faulty(*a, **kw):
        return orig(*a, **dict(kw, steps=0))

    monkeypatch.setattr(ml, "_fit", faulty)


def _fit_misreports_its_logl(monkeypatch):
    from repro_torch.phylo import ml
    orig = ml._fit

    def faulty(*a, **kw):
        bl, pr, ll = orig(*a, **kw)
        return bl, pr, ll * (1 + 1e-3)

    monkeypatch.setattr(ml, "_fit", faulty)


def _half_the_patterns(monkeypatch):
    from repro_torch.core import likelihood
    orig = likelihood.compress_patterns

    def faulty(msa):
        pat, w = orig(msa)
        keep = np.arange(pat.shape[1]) % 2 == 0
        return pat[:, keep], 2.0 * w[keep]

    monkeypatch.setattr(likelihood, "compress_patterns", faulty)


ML_FAULTS = {"a fit returns its start": (_fit_returns_its_start,
                                         "fit_gap"),
             "a fit misreports its logL": (_fit_misreports_its_logl,
                                           "fit_gap"),
             "half the site patterns, weights doubled": (
                 _half_the_patterns, "fit_gap")}


def test_ml_refine_sound_run_is_correct():
    out = _run("mtgenome.ml_refine")
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", list(ML_FAULTS))
def test_ml_refine_planted_fault_is_caught(monkeypatch, fault):
    plant, check = ML_FAULTS[fault]
    plant(monkeypatch)
    out = _run("mtgenome.ml_refine")
    assert not out["correct"]
    c = out["checks"][check]
    assert not c["value"] <= c["limit"], out["checks"]


def test_ml_refine_control_in_tf32_fails():
    checks = _control("mtgenome.ml_refine", "tf32")
    assert not prun.passed(checks), checks
    for k in ("fit_gap", "ll_start"):
        assert checks[k]["value"] > checks[k]["limit"], checks
