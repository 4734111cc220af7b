"""Port parity: the Gotoh forward kernel wrapper against the Pallas kernel.

On a CPU tensor ``repro_torch.kernels.sw.ops.gotoh_forward`` runs the
kernel's plain version; it must reproduce the reference Pallas kernel
(run in interpret mode) exactly: the full (B, n+1, m+1) direction tensor
— rows past ``la`` included, where the row state freezes — and every
record field. The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alphabet as jab
from repro.kernels.sw.ops import gotoh_forward_pallas
from repro_torch.kernels.sw import ops


def _case(seed, B, n, m, n_chars=4):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, n_chars, (B, n)).astype(np.int8)
    Bm = rng.integers(0, n_chars, (B, m)).astype(np.int8)
    lens = np.stack([rng.integers(0, n + 1, B),
                     rng.integers(0, m + 1, B)], 1).astype(np.int32)
    lens[0] = (0, m)
    lens[1] = (n, 0)
    lens[2] = (1, 1)
    return A, Bm, lens


def _compare(A, Bm, lens, sub, go, local, block_rows):
    ref = gotoh_forward_pallas(jnp.asarray(A), jnp.asarray(Bm),
                               jnp.asarray(lens), jnp.asarray(sub),
                               gap_open=go, gap_extend=1, local=local,
                               block_rows=block_rows, interpret=True)
    out = ops.gotoh_forward(torch.from_numpy(A), torch.from_numpy(Bm),
                            torch.from_numpy(lens), torch.from_numpy(sub),
                            gap_open=go, gap_extend=1, local=local)
    for name in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(out, name).numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("B,n,m,block", [(4, 32, 48, 16), (3, 40, 24, 32)])
@pytest.mark.parametrize("local", [False, True])
def test_plain_kernel_matches_pallas_dna(B, n, m, block, local):
    A, Bm, lens = _case(B * n + local, B, n, m)
    sub = np.asarray(jab.dna_matrix(), np.float32)
    _compare(A, Bm, lens, sub, 3, local, block)


@pytest.mark.parametrize("local", [False, True])
def test_plain_kernel_matches_pallas_blosum(local):
    A, Bm, lens = _case(5, 3, 24, 20, n_chars=21)
    sub = np.asarray(jab.blosum62(), np.float32)
    _compare(A, Bm, lens, sub, 11, local, 16)


def test_broadcast_target_matches_per_pair_target():
    A, Bm, lens = _case(9, 5, 20, 17)
    lens[:, 1] = 15
    a = torch.from_numpy(A)
    sub = torch.as_tensor(np.asarray(jab.dna_matrix(), np.float32))
    b1 = torch.from_numpy(Bm[:1])
    wide = ops.gotoh_forward(a, b1.expand(5, 17), torch.from_numpy(lens),
                             sub, gap_open=3, gap_extend=1)
    full = ops.gotoh_forward(a, b1.repeat(5, 1), torch.from_numpy(lens),
                             sub, gap_open=3, gap_extend=1)
    for x, y in zip(wide, full):
        assert torch.equal(x, y)


def test_wrapper_rejects_bad_inputs_and_counts_no_cpu_launch():
    a = torch.zeros((2, 8), dtype=torch.int8)
    b = torch.zeros((2, 6), dtype=torch.int8)
    lens = torch.tensor([[8, 6], [4, 3]], dtype=torch.int32)
    sub = torch.zeros((5, 5), dtype=torch.float32)
    before = ops.launches
    ops.gotoh_forward(a, b, lens, sub, gap_open=3, gap_extend=1)
    assert ops.launches == before
    with pytest.raises(TypeError):
        ops.gotoh_forward(a.int(), b, lens, sub, gap_open=3, gap_extend=1)
    with pytest.raises(ValueError):
        ops.gotoh_forward(a, b, lens.long(), sub, gap_open=3, gap_extend=1)
    with pytest.raises(ValueError):
        ops.gotoh_forward(a, b[:1], lens, sub, gap_open=3, gap_extend=1)
    with pytest.raises(ValueError):
        ops.gotoh_forward(a, b, lens, sub[:, :4], gap_open=3, gap_extend=1)
