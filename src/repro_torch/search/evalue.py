"""Karlin–Altschul statistics: raw DP scores -> bit scores -> e-values.

The search engine ranks candidate pairs by their Smith–Waterman (or
global Gotoh) score; a raw score is meaningless across queries of
different lengths or databases of different sizes, so hits are reported
in the standard extreme-value frame:

  bits  = (lambda * S - ln K) / ln 2
  E     = m * N * 2^(-bits)

with ``m`` the query length and ``N`` the total residue count of the
database (the search space). ``lambda``/``K`` are the Gumbel parameters
of the scoring system; the defaults below are the published ungapped
nucleotide values for a +2/-3-class matrix (lambda=1.28, K=0.46) and are
*nominal* — this engine uses them as a calibrated ranking transform, not
as a claim of exact gapped statistics (fitting gapped parameters per
matrix is out of scope; docs/SEARCH.md spells out the semantics). Both
are exposed on ``SearchConfig`` for callers who fit their own.

Everything here is pure numpy on tiny (n_candidates,) vectors — it runs
after the device-side scoring, on the host reduction path. (A copy of
``repro.search.evalue``: the port imports nothing of the reference.)
"""
from __future__ import annotations

import math

import numpy as np

# nominal ungapped DNA Gumbel parameters (blastn-class scoring)
DEFAULT_LAMBDA = 1.28
DEFAULT_K = 0.46


def bit_scores(scores, *, lam: float = DEFAULT_LAMBDA,
               k_const: float = DEFAULT_K) -> np.ndarray:
    """Normalized bit scores: (lambda*S - ln K) / ln 2."""
    s = np.asarray(scores, np.float64)
    return (lam * s - math.log(k_const)) / math.log(2.0)


def evalues(scores, query_lens, db_residues: int, *,
            lam: float = DEFAULT_LAMBDA,
            k_const: float = DEFAULT_K) -> np.ndarray:
    """Expected chance hits at or above each score: m * N * 2^-bits.

    ``query_lens`` broadcasts against ``scores`` (per-candidate query
    length m); ``db_residues`` is the summed true length of every
    database sequence — the search space is the same for every query
    against one index, which keeps e-values comparable across a batch.
    Exponents are clamped so a pathological score can never overflow to
    inf/0 silently.
    """
    bits = bit_scores(scores, lam=lam, k_const=k_const)
    m = np.asarray(query_lens, np.float64)
    space = m * float(max(int(db_residues), 1))
    return space * np.exp2(np.clip(-bits, -1022.0, 1022.0))
