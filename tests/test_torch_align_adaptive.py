"""Port parity: the adaptive band policy against the JAX package.

``repro_torch.align.bucketing.band_bucket_plan`` against the reference's
planner, and ``AlignEngine(band_policy="adaptive").align_pairs`` on both
banded routes (CPU tensors: the kernels' plain versions) against the
reference's adaptive ``banded`` engine: scores, rows, lengths, fallbacks
and calls equal, buckets past W = 1,024 included. The reference's fused
route cannot run under the local JAX (``pl.store``), so its ``banded``
route is the oracle for both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.align import bucketing as jbk
from repro.align.engine import AlignEngine as JEngine
from repro.core import alphabet as jab
from repro_torch.align import backends, bucketing
from repro_torch.align.engine import AlignEngine
from repro_torch.kernels.banded import ops

SUB = np.asarray(jab.dna_matrix(), np.float32)
KW = dict(gap_open=3, gap_extend=1, gap_code=5)


def _same_plan(a, b):
    assert len(a) == len(b)
    for (wq, wt, W, ix), (jwq, jwt, jW, jix) in zip(a, b):
        assert (wq, wt, W) == (jwq, jwt, jW)
        np.testing.assert_array_equal(ix, jix)


@pytest.mark.parametrize("kind", ["random", "skewed", "clamped"])
def test_band_bucket_plan_equals_reference(kind):
    rng = np.random.default_rng({"random": 1, "skewed": 2, "clamped": 3}[kind])
    B, Lq, Lt = 200, 600, 3000
    if kind == "random":
        qlens = rng.integers(0, Lq + 1, B)
        tlens = rng.integers(0, Lt + 1, B)
    elif kind == "skewed":
        # partial reads against full-length targets
        qlens = rng.integers(40, Lq + 1, B)
        tlens = rng.integers(Lt - 100, Lt + 1, B)
    else:
        # long queries against short targets: W clamped to 2 t_width + 2
        qlens = rng.integers(Lq - 50, Lq + 1, B)
        tlens = rng.integers(1, 40, B)
        Lt = 64
    for band in (8, 64, 333):
        for mb in (16, 32):
            plan = bucketing.band_bucket_plan(qlens, tlens, Lq, Lt, band=band,
                                              min_bucket=mb)
            _same_plan(plan, jbk.band_bucket_plan(qlens, tlens, Lq, Lt,
                                                  band=band, min_bucket=mb))
            if kind == "clamped":
                assert all(W == 1 << int(np.ceil(np.log2(2 * wt + 2)))
                           for _, wt, W, _ in plan)
    assert bucketing.band_bucket_plan([], [], 8, 8, band=8) == []


def test_band_policy_validated():
    with pytest.raises(ValueError, match="band_policy"):
        AlignEngine(torch.from_numpy(SUB), gap_open=3, gap_extend=1,
                    backend="banded", band_policy="wide")
    for policy in ("fixed", "adaptive"):
        AlignEngine(torch.from_numpy(SUB), gap_open=3, gap_extend=1,
                    backend="banded", band_policy=policy)


def _fixture_random():
    """The reference's own test fixture (``test_align_engine.py``)."""
    rng = np.random.default_rng(21)
    B, n = 12, 96
    Q = rng.integers(0, 4, (B, n)).astype(np.int8)
    T = rng.integers(0, 4, (B, n)).astype(np.int8)
    qlens = rng.integers(1, n + 1, B).astype(np.int32)
    tlens = rng.integers(1, n + 1, B).astype(np.int32)
    return Q, qlens, T, tlens


def _fixture_skewed():
    """Short reads against long targets at band 64, each read a fragment of
    a mutated copy of its target, placed where the skew-wide band holds
    its path: buckets at W = 2,048 and 4,096 (and a near-diagonal pair).
    The skews leave the band's left edge ~50 columns from the unrelated
    diagonal out of (0, 0), whose cells are each early row's best: a skew
    just under W / 2 would press that edge and send the pair to the full
    DP in both packages."""
    rng = np.random.default_rng(5)
    spec = [(40, 1010, 400), (44, 1020, 300), (36, 1000, 600),
            (100, 2100, 800), (96, 2086, 1200), (60, 70, 5)]
    B = len(spec)
    Lq, Lt = 128, 2600
    Q = np.full((B, Lq), 5, np.int8)
    T = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    for i, (la, lb, p) in enumerate(spec):
        frag = T[i, p:p + la].copy()
        hit = rng.random(la) < 0.05
        frag[hit] = rng.integers(0, 4, int(hit.sum()))
        Q[i, :la] = frag
    qlens = np.array([s[0] for s in spec], np.int32)
    tlens = np.array([s[1] for s in spec], np.int32)
    return Q, qlens, T, tlens


def _reference(Q, qlens, T, tlens, band, policy):
    return JEngine(jnp.asarray(SUB), backend="banded", band=band,
                   band_policy=policy, **KW).align_pairs(
        jnp.asarray(Q), jnp.asarray(qlens), jnp.asarray(T),
        jnp.asarray(tlens))


def _port(Q, qlens, T, tlens, band, policy, backend):
    return AlignEngine(torch.from_numpy(SUB), backend=backend, band=band,
                       band_policy=policy, **KW).align_pairs(
        torch.from_numpy(Q), torch.from_numpy(qlens), torch.from_numpy(T),
        torch.from_numpy(tlens))


def _same(res, ref):
    for name in ("score", "a_row", "b_row", "aln_len"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (res.n_fallback, res.n_calls) == (ref.n_fallback, ref.n_calls)


@pytest.mark.parametrize("backend", ["banded", "banded-pallas"])
@pytest.mark.parametrize("fixture", ["random", "skewed"])
def test_adaptive_align_pairs_equals_reference(backend, fixture):
    Q, qlens, T, tlens = (_fixture_random if fixture == "random"
                          else _fixture_skewed)()
    band = 8 if fixture == "random" else 64
    plan = bucketing.band_bucket_plan(qlens, tlens, Q.shape[1], T.shape[1],
                                      band=band)
    if fixture == "skewed":
        assert {2048, 4096} <= {W for *_, W, _ in plan}
    ref = _reference(Q, qlens, T, tlens, band, "adaptive")
    adapt = _port(Q, qlens, T, tlens, band, "adaptive", backend)
    _same(adapt, ref)
    fixed = _port(Q, qlens, T, tlens, band, "fixed", backend)
    _same(fixed, _reference(Q, qlens, T, tlens, band, "fixed"))
    # the fixed band is too thin; the adaptive band designs skew-driven
    # overflow away (the reference asserts the same)
    assert fixed.n_fallback > 0
    assert adapt.n_fallback < fixed.n_fallback
    if fixture == "skewed":
        # the wide buckets' pairs stay in their bands: the band's rows, not
        # the full-DP fallback's
        assert adapt.n_fallback == 0


def test_adaptive_band_past_the_kernels_limit_raises_before_any_launch():
    """The planner would give W = 32,768 here; the engine refuses before
    any call (the reference's kernels take any W), on the CPU as the
    card would."""
    Q = torch.zeros((1, 4), dtype=torch.int8)
    T = torch.zeros((1, 20000), dtype=torch.int8)
    eng = AlignEngine(torch.from_numpy(SUB), backend="banded-pallas",
                      band=64, band_policy="adaptive", **KW)
    before = (ops.forward_launches, ops.fused_launches)
    with pytest.raises(ValueError, match=f"limit {ops.MAX_BAND}"):
        eng.align_pairs(Q, torch.tensor([4]), T, torch.tensor([20000]))
    assert (ops.forward_launches, ops.fused_launches) == before
    # a local engine ignores the policy (a band cannot host a local path)
    loc = AlignEngine(torch.from_numpy(SUB), backend="banded", band=8,
                      band_policy="adaptive", local=True, **KW)
    Qr, qlens, Tr, tlens = _fixture_random()
    res = loc.align_pairs(torch.from_numpy(Qr), torch.from_numpy(qlens),
                          torch.from_numpy(Tr), torch.from_numpy(tlens))
    assert res.n_fallback == 0


def test_banded_forward_route_chunks_by_the_direction_budget(monkeypatch):
    """A banded batch past ``DIRS_BUDGET`` runs in chunks of pairs with the
    same results (the full DP's rule)."""
    Q, qlens, T, tlens = _fixture_skewed()
    args = (torch.from_numpy(Q), torch.from_numpy(qlens),
            torch.from_numpy(T), torch.from_numpy(tlens),
            torch.from_numpy(SUB))
    kw = dict(gap_open=3, gap_extend=1, band=2048, gap_code=5)
    whole = backends.banded_align_pairs(*args, **kw)
    monkeypatch.setattr(backends, "DIRS_BUDGET", 2 * Q.shape[1] * 2048)
    calls = []
    real = ops.banded_forward

    def counted(a, *rest, **k):
        calls.append(a.shape[0])
        return real(a, *rest, **k)
    monkeypatch.setattr(backends.banded_ops, "banded_forward", counted)
    parts = backends.banded_align_pairs(*args, **kw)
    assert calls == [2, 2, 2]
    for x, y in zip(whole, parts):
        assert torch.equal(x, y)
