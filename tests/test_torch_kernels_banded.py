"""Port parity: the banded kernels' plain versions against the JAX package.

``kernels.banded.ops`` on CPU tensors runs the plain version of
``csrc/banded_forward.cu`` and ``csrc/banded_fused.cu``; the same numpy
inputs go through the JAX band scan (``repro.align.banded``) and the
Pallas forward kernel in interpret mode. Exact on scores, start state,
edge flags, every direction byte, aligned rows, lengths and ok flags.
The JAX fused kernel cannot run under the local JAX (``pl.store``), so
kernel 4's oracle is the JAX forward + traceback, as in
``tests/test_kernels_banded.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.align import banded as jb
from repro.core import alphabet as jab
from repro.core import pairwise as jpw
from repro.kernels.banded.ops import banded_forward_pallas
from repro_torch.align import banded as tb
from repro_torch.kernels.banded import ops

SUB = np.asarray(jab.dna_matrix(), np.float32)
TSUB = torch.from_numpy(SUB)


def _case(seed, B, n, m):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 4, (B, n)).astype(np.int8)
    T = rng.integers(0, 4, (B, m)).astype(np.int8)
    lens = np.stack([rng.integers(0, n + 1, B),
                     rng.integers(0, m + 1, B)], 1).astype(np.int32)
    lens[0] = (0, m)              # empty query
    lens[1] = (n, 0)              # empty target
    lens[2] = (1, 1)              # length-1 pair
    lens[-1] = (n, m)             # full width
    return A, T, lens


def _slide_case(seed, B, n, m):
    """Pairs whose band slides by more than one column a row: lb >= 3 la,
    la = 1 with lb = m, and lb = 1 with la = n (the band then stays put)."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 4, (B, n)).astype(np.int8)
    T = rng.integers(0, 4, (B, m)).astype(np.int8)
    la = rng.integers(1, n // 3 + 1, B)
    lb = np.minimum(m, 3 * la + rng.integers(0, m, B))
    lens = np.stack([la, lb], 1).astype(np.int32)
    lens[0] = (1, m)
    lens[1] = (n, 1)
    lens[2] = (2, m)
    return A, T, lens


def _jax_forward(A, T, lens, go, ge, W):
    return jax.vmap(lambda q, t, l: jb.banded_forward(
        q, l[0], t, l[1], jnp.asarray(SUB), go, ge, band=W))(
            jnp.asarray(A), jnp.asarray(T), jnp.asarray(lens))


def _jax_pairs(A, T, lens, go, ge, W, gap=5):
    def one(q, t, l):
        f = jb.banded_forward(q, l[0], t, l[1], jnp.asarray(SUB), go, ge,
                              band=W)
        ar, br, k, ok = jb.banded_traceback(q, t, f, gap, band=W)
        return f.score, ar, br, k, ok
    return jax.vmap(one)(jnp.asarray(A), jnp.asarray(T), jnp.asarray(lens))


def _port(fn, A, T, lens, **kw):
    return fn(torch.from_numpy(A), torch.from_numpy(T),
              torch.from_numpy(lens), TSUB, **kw)


def _eq(x, y, what):
    np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=what)


@pytest.mark.parametrize("B,n,m,W,slides", [
    pytest.param(5, 32, 32, 8, False, id="5-32-32-8"),
    pytest.param(5, 40, 24, 16, False, id="5-40-24-16"),
    pytest.param(4, 24, 40, 64, False, id="4-24-40-64"),
    pytest.param(4, 20, 20, 42, False, id="4-20-20-42"),
    pytest.param(6, 12, 48, 8, True, id="slides-6-12-48-8"),
    pytest.param(5, 9, 60, 16, True, id="slides-5-9-60-16"),
])
@pytest.mark.parametrize("go,ge", [(3, 1), (5, 2)])
def test_forward_plain_matches_jax_scan_and_pallas(B, n, m, W, slides, go,
                                                   ge):
    """Against the vmapped jnp scan and the Pallas kernel (interpret):
    score, start, state, edge and the whole (B, n, W) direction tensor
    (the band state advances past ``la`` in all three); ``slides``: band
    slides above one column a row (``_slide_case``)."""
    A, T, lens = (_slide_case if slides else _case)(n * 100 + W, B, n, m)
    got = _port(ops.banded_forward, A, T, lens, gap_open=go, gap_extend=ge,
                band=W)
    scan = _jax_forward(A, T, lens, go, ge, W)
    pallas = banded_forward_pallas(
        jnp.asarray(A), jnp.asarray(T), jnp.asarray(lens), jnp.asarray(SUB),
        gap_open=go, gap_extend=ge, band=W, block_rows=8, interpret=True)
    for name, ref in (("scan", scan), ("pallas", pallas)):
        for field in ("dirs", "score", "start_i", "start_j", "start_state",
                      "edge"):
            _eq(getattr(got, field).numpy(), getattr(ref, field),
                f"{name} {field}")


@pytest.mark.parametrize("go,ge", [(3, 1), (5, 2)])
def test_full_coverage_band_equals_full_dp(go, ge):
    """With ``W >= 2*lb + 2`` the band covers every column: the banded
    score is the full Gotoh forward's, and no pair is flagged."""
    B, n, m = 6, 24, 30
    A, T, lens = _case(7 + go, B, n, m)
    W = 2 * m + 2
    got = _port(ops.banded_forward, A, T, lens, gap_open=go, gap_extend=ge,
                band=W)
    full = jax.vmap(lambda q, t, l: jpw.gotoh_forward(
        q, l[0], t, l[1], jnp.asarray(SUB), go, ge).score)(
            jnp.asarray(A), jnp.asarray(T), jnp.asarray(lens))
    _eq(got.score.numpy(), full, "score")
    score, _, _, _, ok = _port(ops.banded_pairs_fused, A, T, lens,
                               gap_open=go, gap_extend=ge, band=W)
    _eq(score.numpy(), full, "fused score")
    assert bool(ok.all())


@pytest.mark.parametrize("B,n,m,W,slides", [
    pytest.param(5, 32, 32, 8, False, id="5-32-32-8"),
    pytest.param(4, 48, 32, 16, False, id="4-48-32-16"),
    pytest.param(3, 24, 48, 64, False, id="3-24-48-64"),
    pytest.param(6, 12, 48, 8, True, id="slides-6-12-48-8"),
    pytest.param(5, 9, 60, 16, True, id="slides-5-9-60-16"),
    pytest.param(4, 15, 50, 64, True, id="slides-4-15-50-64"),
])
def test_fused_plain_matches_jax_forward_traceback(B, n, m, W, slides):
    """Scores, aligned rows, lengths and ok flags equal the JAX band
    forward + traceback; ``slides`` as in the forward test (the la = 1,
    lb = m pair walks through row 0 and on to negative rows, where the
    reference's clamped reads reach rows past la)."""
    A, T, lens = (_slide_case if slides else _case)(n + m + W, B, n, m)
    got = _port(ops.banded_pairs_fused, A, T, lens, gap_open=3,
                gap_extend=1, band=W)
    ref = _jax_pairs(A, T, lens, 3, 1, W)
    for name, x, y in zip(("score", "a_row", "b_row", "aln_len", "ok"),
                          got, ref):
        _eq(x.numpy(), y, name)
    # align.banded.banded_align_pair: the same alignment, as an AlignResult
    res, ok = tb.banded_align_pair(
        torch.from_numpy(A), torch.from_numpy(lens[:, 0]),
        torch.from_numpy(T), torch.from_numpy(lens[:, 1]), TSUB,
        gap_open=3, gap_extend=1, band=W)
    jres, jok = jax.vmap(lambda q, t, l: jb.banded_align_pair(
        q, l[0], t, l[1], jnp.asarray(SUB), gap_open=3, gap_extend=1,
        band=W))(jnp.asarray(A), jnp.asarray(T), jnp.asarray(lens))
    for name in jres._fields:
        _eq(getattr(res, name).numpy(), getattr(jres, name), name)
    _eq(ok.numpy(), jok, "ok")


@pytest.mark.parametrize("B,n,m,W,slides", [
    pytest.param(4, 20, 300, 2048, False, id="4-20-300-2048"),
    pytest.param(4, 16, 200, 4096, True, id="slides-4-16-200-4096"),
    pytest.param(3, 12, 2500, 2048, True, id="slides-3-12-2500-2048"),
])
def test_wide_band_plain_versions_match_jax(B, n, m, W, slides):
    """Past the warp route's 1,024 (the kernels' wide route), the plain
    versions of both kernels against the JAX band scan and its traceback:
    every direction byte, score, start state and edge flag, and the rows,
    lengths and ok flags; with slides of ~200 columns a row."""
    A, T, lens = (_slide_case if slides else _case)(W + m, B, n, m)
    got = _port(ops.banded_forward, A, T, lens, gap_open=3, gap_extend=1,
                band=W)
    scan = _jax_forward(A, T, lens, 3, 1, W)
    for field in ("dirs", "score", "start_i", "start_j", "start_state",
                  "edge"):
        _eq(getattr(got, field).numpy(), getattr(scan, field), field)
    fused = _port(ops.banded_pairs_fused, A, T, lens, gap_open=3,
                  gap_extend=1, band=W)
    for name, x, y in zip(("score", "a_row", "b_row", "aln_len", "ok"),
                          fused, _jax_pairs(A, T, lens, 3, 1, W)):
        _eq(x.numpy(), y, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_escape_sweep_flags_match_jax(seed):
    """The seeded adversarial sweep of ``tests/test_kernels_banded.py``
    (random unrelated 24-mers at band 8): the ok flags and scores equal
    the JAX band's, and no unflagged pair scores below the full DP."""
    rng = np.random.default_rng(seed)
    B, n, W, go, ge = 100, 24, 8, 3, 1
    Q = rng.integers(0, 4, (B, n)).astype(np.int8)
    T = rng.integers(0, 4, (B, n)).astype(np.int8)
    lens = np.stack([rng.integers(1, n + 1, B),
                     rng.integers(1, n + 1, B)], 1).astype(np.int32)
    full = np.asarray(jax.vmap(lambda q, t, l: jpw.score_only(
        q, l[0], t, l[1], jnp.asarray(SUB), gap_open=go, gap_extend=ge))(
            jnp.asarray(Q), jnp.asarray(T), jnp.asarray(lens)))
    jscore, _, _, _, jok = _jax_pairs(Q, T, lens, go, ge, W)
    score, _, _, _, ok = _port(ops.banded_pairs_fused, Q, T, lens,
                               gap_open=go, gap_extend=ge, band=W)
    score, ok = score.numpy(), ok.numpy()
    _eq(ok, jok, "ok")
    _eq(score, jscore, "score")
    assert not (ok & (score != full)).any()
    assert (ok & (score == full)).sum() > 0


def test_wrappers_reject_bad_inputs_and_count_no_cpu_launch():
    A, T, lens = _case(3, 4, 16, 16)
    a, t, ln = torch.from_numpy(A), torch.from_numpy(T), \
        torch.from_numpy(lens)
    before = (ops.forward_launches, ops.fused_launches)
    kw = dict(gap_open=3, gap_extend=1)
    for fn in (ops.banded_forward, ops.banded_pairs_fused):
        with pytest.raises(TypeError):
            fn(a.to(torch.int32), t, ln, TSUB, band=8, **kw)
        with pytest.raises(ValueError, match="lens"):
            fn(a, t, ln.to(torch.int64), TSUB, band=8, **kw)
        with pytest.raises(ValueError, match=f"band {ops.MAX_BAND + 1} "
                           f"outside the kernels' 1..{ops.MAX_BAND}"):
            fn(a, t, ln, TSUB, band=ops.MAX_BAND + 1, **kw)
        fn(a, t, ln, TSUB, band=ops.WARP_MAX_BAND + 1, **kw)   # wide route
        with pytest.raises(ValueError, match="band"):
            fn(a, t, ln, TSUB, band=0, **kw)
        with pytest.raises(ValueError):
            fn(a, t[:2], ln, TSUB, band=8, **kw)
        with pytest.raises(ValueError, match="sub"):
            fn(a, t, ln, TSUB.double(), band=8, **kw)
        fn(a, t, ln, TSUB, band=8, **kw)            # the plain version
    assert (ops.forward_launches, ops.fused_launches) == before
    assert (ops.MAX_BAND, ops.WARP_MAX_BAND) == (16384, 1024)
    # the fused kernel's band lives in a workspace of the plan's pair
    # slots, whatever the lengths (the first design kept short bands in
    # shared memory)
    for n, m in ((1447, 1486), (4096, 4096), (200, 180), (37, 53)):
        plan = ops.fused_plan(16384, n, m, 64, 528)
        assert plan.workspace_bytes == plan.grid * ops.PAIRS_PER_CTA \
            * plan.slot_bytes >= plan.grid * ops.PAIRS_PER_CTA * n * 32


@pytest.mark.parametrize("n,m,W", [
    (1447, 1486, 64), (3735, 1493, 64), (200, 180, 64), (37, 53, 8),
    (1700, 1800, 128), (4096, 4200, 64), (300, 400, 1024), (90, 120, 256),
    (2048, 1500, 2048), (1024, 1100, 1025), (8192, 8192, 16384),
])
def test_launch_plans_fit_the_card_and_bound_the_workspace(n, m, W):
    """Kernel 4's launch plan as pure arithmetic: every pair covered by
    the pair slots of the grid (a persistent grid's slot p takes pairs p,
    p + slots, ...), no more CTAs than the card holds at once nor more
    slots than ``WORKSPACE_BUDGET`` holds (one CTA at least), and a
    workspace of one slot a pair slot (the packed band, n rows of 16 K
    bytes for 32 K >= W cells, then the walk's moves at 2 bits a step),
    the same for any B past what the card holds. Past W = 1,024 a CTA
    holds one pair (the wide route)."""
    K = ops.cells_per_lane(W)
    assert 32 * K >= W and (K == 1 or 16 * K < W)
    assert ops.band_pitch(W) == 16 * K
    per = ops.pairs_per_cta(W)
    assert per == (ops.PAIRS_PER_CTA if W <= 1024 else 1)
    slot = n * 16 * K + -(-((n + m + 15) // 16 * 4) // 16) * 16
    fit = max(1, ops.WORKSPACE_BUDGET // (per * slot))
    for ctas in (132, 528, 1056):
        for B in (1, 13, 1000, 16384, 65536):
            plan = ops.fused_plan(B, n, m, W, ctas)
            assert plan.slot_bytes == slot
            assert 1 <= plan.grid <= min(ctas, fit)
            slots = plan.grid * per
            assert slots >= B or plan.grid == min(ctas, fit)
            assert plan.workspace_bytes == slots * slot
            assert plan.workspace_bytes <= max(ops.WORKSPACE_BUDGET,
                                               per * slot)
        # the workspace stops growing with B once the grid is full
        big = {ops.fused_plan(B, n, m, W, ctas).workspace_bytes
               for B in (8 * ctas, 65536, 1 << 20)}
        assert big == {min(ctas, fit) * per * slot}
    if W == 16384:
        # the widest band at n = 8,192: 67 MB a slot, 31 slots in 2 GiB
        assert slot == 8192 * 8192 + 4096 and fit == 31
        assert ops.fused_plan(4096, n, m, W, 132).grid == 31
    # at the search shape: 4 CTAs of 8 pair slots an SM on 132 SMs, each
    # slot a band of 1,447 rows x 32 bytes and 2,933 moves (~196 MB)
    if (n, m, W) == (1447, 1486, 64):
        at_search = ops.fused_plan(16384, n, m, W, 528)
        assert at_search.grid == 528
        assert at_search.workspace_bytes == 528 * 8 * (1447 * 32 + 736)


def test_plans_take_sequences_of_any_length():
    """No length limit: the kernels stage sequences in windows of shared
    memory, and kernel 4's workspace grows with n (its band) and n + m
    (its moves) only."""
    plan = ops.fused_plan(4, 150_000, 100_000, 64, 528)
    assert plan.grid == 1
    assert plan.workspace_bytes == 8 * (150_000 * 32 + 62_512)
    assert ops.fused_plan(4, 2_000, 240_000, 64, 528).slot_bytes \
        == 2_000 * 32 + 60_512
