"""Port parity on the Phi_RNA-shaped family that ``chip_smoke.py`` drives.

The port keeps its own copy of the simulator; it must give the reference's
family, and both packages must fail the same k-mer chains on it. The
failing-chain counts grow with the number of leaves because the random
join tree deepens (about 2 ln N branches from the root to a leaf), so
leaves drift further from the center: at 4,096 leaves most chains fail in
both packages alike.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmer_index as jk
from repro.core import msa as jmsa
from repro.data import SimConfig as JSimConfig
from repro.data import simulate_family as jsimulate
from repro_torch.core import kmer_index as tk
from repro_torch.core import msa as tmsa
from repro_torch.data import SimConfig as TSimConfig
from repro_torch.data import simulate_family as tsimulate

# data/datasets.py::phi_rna's parameters (16S rRNA analogue)
PHI_RNA = dict(root_len=1440, branch_sub=0.01, branch_indel=0.001, seed=1)


@functools.lru_cache(maxsize=None)
def _families(n):
    return (jsimulate(JSimConfig(n_leaves=n, **PHI_RNA)),
            tsimulate(TSimConfig(n_leaves=n, **PHI_RNA)))


@pytest.mark.parametrize("n", [48, 4096])
def test_simulate_family_equals_reference(n):
    ref, out = _families(n)
    assert out.names == ref.names and out.seqs == ref.seqs
    np.testing.assert_array_equal(out.children, ref.children)
    np.testing.assert_array_equal(out.blen, ref.blen)
    assert out.root == ref.root


@pytest.mark.parametrize("n, n_failed", [(48, 11), (192, 99), (4096, 3735)])
def test_phi_rna_chain_failures_equal_reference(n, n_failed):
    ref_fam, _ = _families(n)
    cfg = jmsa.MSAConfig()
    S, lens = (np.array(x) for x in jmsa.encode_for_msa(ref_fam.seqs, cfg))
    lc = int(lens[0])
    kw = dict(k=cfg.k, stride=cfg.stride, max_anchors=cfg.max_anchors,
              max_seg=cfg.max_seg)
    table = jk.build_center_index(jnp.asarray(S[0]), lc, k=cfg.k)
    ref = jax.jit(jax.vmap(lambda q, lq: jk.chain_anchors(
        q, lq, table, lc, **kw)))(jnp.asarray(S[1:]), jnp.asarray(lens[1:]))
    out = tk.chain_anchors(
        torch.as_tensor(S[1:]), torch.as_tensor(lens[1:]),
        tk.build_center_index(torch.as_tensor(S[0]), lc, k=cfg.k), lc, **kw)
    np.testing.assert_array_equal(out.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(out.count.numpy(), np.asarray(ref.count))
    assert int((~out.ok).sum()) == n_failed


def test_phi_rna_msa_equals_reference():
    ref_fam, out_fam = _families(48)
    ref = jmsa.center_star_msa(ref_fam.seqs, jmsa.MSAConfig())
    out = tmsa.center_star_msa(out_fam.seqs, tmsa.MSAConfig(), device="cpu")
    assert (out.n_fallback, out.width) == (ref.n_fallback, ref.width) \
        == (11, 1641)
    np.testing.assert_array_equal(out.msa, np.asarray(ref.msa))
