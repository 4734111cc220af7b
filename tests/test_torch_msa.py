"""Port parity: k-mer index, chaining, the align engine and the MSA driver.

Same numpy inputs and the same config values through ``repro`` and
``repro_torch`` (on the CPU); k-mer codes, the center index, anchors and
every MSA byte must be equal, and ``align_pairs`` must give equal rows and
the same number of backend calls.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.align import AlignEngine as JEngine
from repro.core import kmer_index as jk
from repro.core import msa as jmsa
from repro.data import SimConfig, simulate_family
from repro_torch.core import kmer_index as tk
from repro_torch.core import msa as tmsa
from repro_torch.phylo.engine import TreeEngine


def _fallback_family():
    # seed 3 has one pair whose k-mer chain fails -> full-DP realignment
    return simulate_family(SimConfig(n_leaves=16, root_len=400, seed=3)).seqs


def test_msa_config_fields_and_defaults_equal_reference():
    ref = [(f.name, f.default) for f in dataclasses.fields(jmsa.MSAConfig)]
    out = [(f.name, f.default) for f in dataclasses.fields(tmsa.MSAConfig)]
    assert out == ref
    for alphabet in ("dna", "protein"):
        np.testing.assert_array_equal(
            tmsa.MSAConfig(alphabet=alphabet).matrix("cpu").numpy(),
            np.asarray(jmsa.MSAConfig(alphabet=alphabet).matrix()))


@pytest.mark.parametrize("k", [4, 11])
def test_kmer_codes_index_and_anchors_exact(dna_family, k):
    cfg = jmsa.MSAConfig(k=k)
    S, lens = jmsa.encode_for_msa(dna_family, cfg)
    S, lens = np.array(S), np.array(lens)
    S[3, 50:60] = 4                                   # a run of N codes
    jt = jk.build_center_index(jnp.asarray(S[0]), int(lens[0]), k=k)
    tt = tk.build_center_index(torch.from_numpy(S[0]), int(lens[0]), k=k)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())

    jcodes = jax.vmap(lambda q, l: jk.kmer_codes(q, l, k))(
        jnp.asarray(S), jnp.asarray(lens))
    tcodes = tk.kmer_codes(torch.from_numpy(S), torch.from_numpy(lens), k)
    np.testing.assert_array_equal(np.asarray(jcodes), tcodes.numpy())

    kw = dict(k=k, stride=1, max_anchors=32, max_seg=24)
    ja = jax.vmap(lambda q, l: jk.chain_anchors(q, l, jt, int(lens[0]), **kw)
                  )(jnp.asarray(S), jnp.asarray(lens))
    ta = tk.chain_anchors(torch.from_numpy(S), torch.from_numpy(lens), tt,
                          int(lens[0]), **kw)
    for name in ja._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ja, name)),
                                      getattr(ta, name).numpy(), err_msg=name)
    jb = jax.vmap(lambda a, l: jk.segment_bounds(a, l, int(lens[0]), k=k))(
        ja, jnp.asarray(lens))
    tb = tk.segment_bounds(ta, torch.from_numpy(lens), int(lens[0]), k=k)
    for x, y in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def _assert_same_msa(ref, out):
    assert (ref.center_idx, ref.n_fallback, ref.width, ref.center_mode) == (
        out.center_idx, out.n_fallback, out.width, out.center_mode)
    assert ref.msa.dtype == out.msa.dtype
    np.testing.assert_array_equal(ref.msa, out.msa)


@pytest.mark.parametrize("method,center", [("kmer", "first"),
                                           ("plain", "first"),
                                           ("kmer", "sampled")])
def test_center_star_msa_byte_equal_on_fixture(dna_family, method, center):
    kw = dict(method=method, center=center, k=8)
    ref = jmsa.center_star_msa(dna_family, jmsa.MSAConfig(**kw))
    out = tmsa.center_star_msa(dna_family, tmsa.MSAConfig(**kw),
                               device="cpu")
    _assert_same_msa(ref, out)


def test_center_star_msa_byte_equal_with_fallbacks():
    seqs = _fallback_family()
    ref = jmsa.center_star_msa(seqs, jmsa.MSAConfig())
    out = tmsa.center_star_msa(seqs, tmsa.MSAConfig(), device="cpu")
    assert ref.n_fallback > 0
    _assert_same_msa(ref, out)


@pytest.mark.parametrize("local", [False, True])
def test_align_pairs_rows_and_calls_equal_reference(local):
    rng = np.random.default_rng(11)
    B, Lq, Lt = 9, 70, 45
    Q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    T = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    qlens = np.array([70, 3, 33, 64, 65, 1, 20, 40, 0], np.int32)
    tlens = np.array([45, 30, 2, 33, 10, 45, 0, 31, 12], np.int32)
    cfg = jmsa.MSAConfig(local=local)
    ref = JEngine(cfg.matrix(), gap_open=3, gap_extend=1, backend="jnp",
                  local=local, min_bucket=8).align_pairs(Q, qlens, T, tlens)
    eng = dataclasses.replace(tmsa.MSAConfig(local=local).engine("cpu"),
                              min_bucket=8)
    out = eng.align_pairs(Q, qlens, T, tlens)
    assert (ref.n_calls, ref.n_fallback) == (out.n_calls, out.n_fallback)
    assert ref.n_calls > 1
    for name in ("score", "a_row", "b_row", "aln_len"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(out, name).numpy(),
                                      err_msg=name)


def test_engine_rejects_unported_backends():
    # every map(1) backend name of the reference is ported; the tree
    # engine that follows map(1) runs its cluster backend above the dense
    # threshold, and ML refinement on top of it
    for backend in ("auto", "jnp", "pallas", "banded", "banded-pallas"):
        tmsa.MSAConfig(backend=backend).engine("cpu")
    rows = np.random.default_rng(0).integers(0, 4, (65, 8)).astype(np.int8)
    tree = TreeEngine(gap_code=5, n_chars=5, backend="cluster", device="cpu")
    assert tree.build(rows).backend == "cluster"
    ml = dataclasses.replace(tree, refine="ml", model="jc69", ml_steps=3,
                             nni_rounds=0).build(rows)
    assert ml.backend == "cluster+ml" and ml.n_nni == 0
