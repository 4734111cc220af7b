"""Port parity: the banded align routes and the banded ``msa_run``.

``repro_torch.align.AlignEngine`` under ``banded`` (banded forward +
traceback) and ``banded-pallas`` (the fused kernel on the pairs path),
on the CPU, against the JAX ``AlignEngine(backend="banded")``: equal
scores, aligned rows and lengths, and the same band-overflow fallbacks
and backend calls. A local engine or a local override takes the full DP
in both packages. ``repro_torch.launch.msa_run --backend banded-pallas``
writes the JAX run's ``aligned.fasta`` byte for byte.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.align import AlignEngine as JEngine
from repro.core import alphabet as jab
from repro.data import SimConfig, simulate_family, write_fasta
from repro.launch import msa_run as jrun
from repro_torch.align import AlignEngine, backends
from repro_torch.launch import msa_run as trun
from test_torch_msa_run import _splits

SUB = np.asarray(jab.dna_matrix(), np.float32)
BANDED = ("banded", "banded-pallas")


def _seq(rng, n):
    return rng.integers(0, 4, n).astype(np.int8)


def _mutant(rng, s, p_sub=0.05, n_indel=3):
    s = list(s)
    for i in range(len(s)):
        if rng.random() < p_sub:
            s[i] = rng.integers(0, 4)
    for _ in range(n_indel):
        i = int(rng.integers(0, len(s)))
        if rng.random() < 0.5:
            s.insert(i, int(rng.integers(0, 4)))
        elif len(s) > 1:
            del s[i]
    return np.array(s, np.int8)


def _pad(rows, gap=5):
    L = max(len(r) for r in rows)
    out = np.full((len(rows), L), gap, np.int8)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, np.array([len(r) for r in rows], np.int32)


def _batch(seed, B=14):
    """Queries near a center plus unrelated and length-skewed ones, so
    that some pairs overflow a narrow band and fall back to the full DP;
    lengths span two pow2 buckets."""
    rng = np.random.default_rng(seed)
    center = _seq(rng, 60)
    rows = [_mutant(rng, center) for _ in range(B - 4)]
    rows += [_seq(rng, 40), _seq(rng, 70), center[:20], center[5:55]]
    Q, lens = _pad(rows)
    targets = [_mutant(rng, center, n_indel=6) for _ in range(B - 2)]
    targets += [center[:30], _seq(rng, 90)]
    T, tlens = _pad(targets)
    return Q, lens, center, T, tlens


def _engines(backend, band, **kw):
    j = JEngine(jnp.asarray(SUB), gap_open=3, gap_extend=1, backend="banded",
                band=band, **kw)
    t = AlignEngine(torch.from_numpy(SUB), gap_open=3, gap_extend=1,
                    backend=backend, band=band, **kw)
    return j, t


def _same(ref, got, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy(), err_msg=f)


@pytest.mark.parametrize("backend", BANDED)
@pytest.mark.parametrize("band", [8, 16])
def test_align_to_center_equals_reference(backend, band):
    Q, lens, center, _, _ = _batch(band)
    jeng, teng = _engines(backend, band)
    ref = jeng.align_to_center(Q, lens, center, len(center))
    got = teng.align_to_center(torch.from_numpy(Q), torch.from_numpy(lens),
                               torch.from_numpy(center), len(center))
    _same(ref, got, ("score", "a_row", "b_row", "aln_len"))
    assert got.n_fallback == ref.n_fallback
    assert 0 < ref.n_fallback < len(Q)
    assert teng.route == "torch-banded"


@pytest.mark.parametrize("backend", BANDED)
@pytest.mark.parametrize("band", [16, 32])
def test_align_pairs_equals_reference(backend, band):
    Q, lens, _, T, tlens = _batch(100 + band)
    jeng, teng = _engines(backend, band)
    ref = jeng.align_pairs(Q, lens, T, tlens)
    got = teng.align_pairs(torch.from_numpy(Q), torch.from_numpy(lens),
                           torch.from_numpy(T), torch.from_numpy(tlens))
    _same(ref, got, ("score", "a_row", "b_row", "aln_len"))
    assert (got.n_fallback, got.n_calls) == (ref.n_fallback, ref.n_calls)
    assert 0 < ref.n_fallback < len(Q)
    assert ref.n_calls > 2              # several buckets + the fallback


@pytest.mark.parametrize("backend", BANDED)
def test_local_routes_to_full_dp(backend):
    """A local engine on a banded name runs the local full DP, as the
    reference does; so does a local override of a global engine."""
    Q, lens, center, T, tlens = _batch(5)
    jeng, teng = _engines(backend, 16, local=True)
    assert teng.route == "torch" and not teng._is_banded
    ref = jeng.align_pairs(Q, lens, T, tlens)
    got = teng.align_pairs(torch.from_numpy(Q), torch.from_numpy(lens),
                           torch.from_numpy(T), torch.from_numpy(tlens))
    _same(ref, got, ("score", "a_row", "b_row", "aln_len"))
    assert (got.n_fallback, got.n_calls) == (ref.n_fallback, ref.n_calls)

    jeng, teng = _engines(backend, 16)
    ref = jeng.batch_fn(local=True)(jnp.asarray(Q), jnp.asarray(lens),
                                    jnp.asarray(center), len(center))
    got = teng.batch_fn(local=True)(torch.from_numpy(Q),
                                    torch.from_numpy(lens),
                                    torch.from_numpy(center), len(center))
    _same(ref, got, ("score", "a_row", "b_row", "aln_len", "ok"))


@pytest.fixture(scope="module")
def banded_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("msa_run_banded")
    fam = simulate_family(SimConfig(n_leaves=48, root_len=300, seed=1,
                                    branch_sub=0.03))
    write_fasta(d / "in.fa", fam.names, fam.seqs)
    for method in ("kmer", "plain"):
        jrun.main(["--fasta", str(d / "in.fa"), "--out", str(d / f"j{method}"),
                   "--method", method, "--backend", "banded"])
        trun.main(["--fasta", str(d / "in.fa"), "--out", str(d / f"t{method}"),
                   "--method", method, "--backend", "banded-pallas",
                   "--device", "cpu"])
    return d, fam.names


@pytest.mark.parametrize("method", ["kmer", "plain"])
def test_msa_run_banded_byte_identical(banded_runs, method):
    d, names = banded_runs
    ref, out = d / f"j{method}", d / f"t{method}"
    assert (out / "aligned.fasta").read_bytes() == \
        (ref / "aligned.fasta").read_bytes()
    ref_splits = _splits((ref / "tree.nwk").read_text(), names)
    assert len(ref_splits) == len(names) - 3
    assert _splits((out / "tree.nwk").read_text(), names) == ref_splits
    jr = json.loads((ref / "report.json").read_text())
    tr = json.loads((out / "report.json").read_text())
    assert (tr["kmer_fallbacks"], tr["width"]) == \
        (jr["kmer_fallbacks"], jr["width"])
    assert tr["backend"] == "torch-banded"


def test_full_dp_batches_past_the_budget_run_in_chunks(monkeypatch):
    """A full-DP batch whose direction bytes pass ``DIRS_BUDGET`` runs in
    chunks of pairs with the same results (here 3 pairs per chunk)."""
    Q, lens, _, T, tlens = _batch(9)
    args = (torch.from_numpy(Q), torch.from_numpy(lens), torch.from_numpy(T),
            torch.from_numpy(tlens), torch.from_numpy(SUB))
    kw = dict(gap_open=3, gap_extend=1, local=True)
    whole = backends.sw_align_pairs(*args, **kw)
    per_pair = (Q.shape[1] + 1) * (T.shape[1] + 1)
    monkeypatch.setattr(backends, "DIRS_BUDGET", 3 * per_pair + 1)
    calls = []
    forward = backends.sw_ops.gotoh_forward
    monkeypatch.setattr(backends.sw_ops, "gotoh_forward",
                        lambda *a, **k: calls.append(1) or forward(*a, **k))
    chunked = backends.sw_align_pairs(*args, **kw)
    assert len(calls) == -(-len(Q) // 3)
    for name, x, y in zip(whole._fields, whole, chunked):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)
