"""Port parity: Mamba2 / SSD (``repro_torch.models.mamba2`` and
``transformer.mamba2_prefill``) against ``repro.models.mamba2`` on the
CPU.

The same numpy inputs and the reference's weights go through both
packages. Tolerances, f32: atol 1e-4 for ``ssd_chunked`` (both sum the
same f32 products in other orders; measured under 1e-5) and for the
mixer's output; the chunked form against the step recurrence at 1e-3, as
``tests/test_models.py`` holds the reference. The conv is bit-exact in
both types (the same products summed in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import mamba2 as jm
from repro.models import transformer as jt
from repro_torch.configs import get_arch
from repro_torch.models import mamba2 as tm
from repro_torch.models import transformer as tt

F32_TOL = 1e-4
ARCH = "mamba2-130m"


def _t(x):
    return torch.from_numpy(np.array(x))


def _ssd_inputs(Bs, Sq, nh, hp, st, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (Bs, Sq, nh, hp)).astype(np.float32),
            rng.uniform(0.01, 0.1, (Bs, Sq, nh)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (nh,)).astype(np.float32),
            rng.normal(0, 1, (Bs, Sq, st)).astype(np.float32),
            rng.normal(0, 1, (Bs, Sq, st)).astype(np.float32))


@pytest.mark.parametrize("Sq", [1, 70, 127, 128, 129, 300])
@pytest.mark.parametrize("chunk", [16, 128])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(Sq, chunk, with_h0):
    Bs, nh, hp, st = 2, 3, 8, 16
    ins = _ssd_inputs(Bs, Sq, nh, hp, st, Sq + chunk)
    h0 = (np.random.default_rng(7).normal(0, 1, (Bs, nh, hp, st))
          .astype(np.float32) if with_h0 else None)
    want, want_h = jm.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk,
                                  h0=None if h0 is None else jnp.asarray(h0))
    got, got_h = tm.ssd_chunked(*map(_t, ins), chunk=chunk,
                                h0=None if h0 is None else _t(h0))
    assert got.shape == (Bs, Sq, nh, hp) and got_h.shape == (Bs, nh, hp, st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               atol=F32_TOL, rtol=0)


def test_ssd_chunked_equals_recurrence():
    Bs, Sq, nh, hp, st = 2, 70, 3, 8, 16
    x, dt, A, Bm, Cm = _ssd_inputs(Bs, Sq, nh, hp, st, 0)
    h = np.zeros((Bs, nh, hp, st))
    ys = []
    for t in range(Sq):
        g = np.exp(dt[:, t] * A[None])
        upd = np.einsum("bs,bh,bhp->bhps", Bm[:, t], dt[:, t], x[:, t])
        h = h * g[:, :, None, None] + upd
        ys.append(np.einsum("bs,bhps->bhp", Cm[:, t], h))
    y_ref = np.stack(ys, 1)
    for chunk in (16, 128):
        y, hN = tm.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk=chunk)
        np.testing.assert_allclose(y.numpy(), y_ref, atol=1e-3)
        np.testing.assert_allclose(hN.numpy(), h, atol=1e-3)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_causal_bit_exact(with_state, dtype):
    rng = np.random.default_rng(3)
    jdt = getattr(jnp, dtype)
    x = jnp.asarray(rng.normal(0, 1, (2, 9, 12)), jdt)
    w = jnp.asarray(rng.normal(0, 0.3, (4, 12)), jdt)
    state = jnp.asarray(rng.normal(0, 1, (2, 3, 12)), jdt) if with_state \
        else None
    want, want_s = jm._conv1d_causal(x, w, state)
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (x, w))
    ts = None if state is None else torch.from_numpy(
        np.array(state.astype(jnp.float32))).to(getattr(torch, dtype))
    got, got_s = tm._conv1d_causal(tx, tw, ts)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if with_state:
        np.testing.assert_array_equal(got_s.float().numpy(),
                                      np.asarray(want_s.astype(jnp.float32)))
    else:
        assert got_s is None and want_s is None


def _mixer(seed=0):
    jcfg, cfg = j_get_arch(ARCH).smoke, get_arch(ARCH).smoke
    jp = jm.init_mamba2_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("S", [1, 2, 3, 40])
def test_mamba2_block_prefill_and_decode_match(S):
    """The mixer without a cache, ``mamba2_prefill`` (its cache too; S <
    K - 1 pads the conv state with zeros) and one O(1) decode step from
    that cache, in f32."""
    jcfg, cfg, jp, tp = _mixer()
    x = np.random.default_rng(S).normal(0, 1, (2, S + 1, cfg.d_model)
                                        ).astype(np.float32)
    want, _ = jm.mamba2_block(jp, jnp.asarray(x[:, :S]), jcfg)
    got, none = tm.mamba2_block(tp, _t(x[:, :S]), cfg)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)
    want_p, want_c = jt.mamba2_prefill(jp, jnp.asarray(x[:, :S]), jcfg,
                                       None)
    got_p, got_c = tt.mamba2_prefill(tp, _t(x[:, :S]), cfg)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               atol=F32_TOL, rtol=0)
    assert got_c["conv"].shape == (2, cfg.d_conv - 1,
                                   cfg.d_inner + 2 * cfg.ssm_state)
    # the conv state is the input projection's last rows (f32 products
    # summed in another order)
    np.testing.assert_allclose(got_c["conv"].numpy(),
                               np.asarray(want_c["conv"]), atol=F32_TOL)
    if S < cfg.d_conv - 1:
        assert not got_c["conv"][:, :cfg.d_conv - 1 - S].any()
    np.testing.assert_allclose(got_c["ssm"].numpy(),
                               np.asarray(want_c["ssm"]), atol=F32_TOL)
    want_d, want_dc = jm.mamba2_block(jp, jnp.asarray(x[:, S:]), jcfg,
                                      cache=want_c)
    got_d, got_dc = tm.mamba2_block(tp, _t(x[:, S:]), cfg, cache=got_c)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               atol=F32_TOL, rtol=0)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(got_dc[name].numpy(),
                                   np.asarray(want_dc[name]), atol=F32_TOL)
    # the step continues the sequence: prefill of S + 1 ends where it does
    full, _ = tt.mamba2_prefill(tp, _t(x), cfg)
    np.testing.assert_allclose(got_d.numpy(), full[:, S:].numpy(),
                               atol=1e-3)


def test_mamba2_block_types_follow_the_reference():
    """A prefill's conv state is in the compute type and its SSM state
    f32, whatever the cache held; a decode step on a state wider than the
    compute type promotes, as jnp does."""
    jcfg, cfg, jp, tp = _mixer(1)
    x = np.random.default_rng(5).normal(0, 1, (2, 6, cfg.d_model)).astype(
        np.float32)
    xb = torch.from_numpy(x).bfloat16()
    _, c = tt.mamba2_prefill(tp, xb, cfg)
    assert c["conv"].dtype == torch.bfloat16 and c["ssm"].dtype == \
        torch.float32
    _, c32 = tt.mamba2_prefill(tp, _t(x), cfg)
    assert c32["conv"].dtype == torch.float32
    # bf16 compute on an f32 conv state: the reference's promotion
    jx = jnp.asarray(x[:, :1], jnp.bfloat16)
    jc = {"conv": jnp.asarray(c32["conv"].numpy()),
          "ssm": jnp.asarray(c32["ssm"].numpy())}
    want, want_c = jm.mamba2_block(jp, jx, jcfg, cache=jc)
    got, got_c = tm.mamba2_block(
        tp, torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16(),
        cfg, cache={k: v.clone() for k, v in c32.items()})
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert got_c["conv"].dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_init_mamba2_params_shapes_and_scales():
    jcfg, cfg, jp, _ = _mixer()
    gen = torch.Generator().manual_seed(0)
    p = tm.init_mamba2_params(gen, cfg)
    assert set(p) == set(jp)
    for name, want in jp.items():
        want = np.asarray(want)
        got = p[name].numpy()
        assert got.shape == want.shape and got.dtype == np.float32, name
        if want.std() > 0:
            assert 0.8 < got.std() / want.std() < 1.25, name
            assert want.min() * 1.25 <= got.mean() <= want.max() * 1.25 \
                or abs(got.mean()) < 0.1, name
        else:
            np.testing.assert_array_equal(got, want)
    # the softplus step's bias lies where the reference draws it:
    # softplus(dt_bias) = exp(U(log 1e-3, log 1e-1))
    step = torch.nn.functional.softplus(p["dt_bias"])
    assert ((step >= 1e-3 * 0.999) & (step <= 1e-1 * 1.001)).all()
    A = torch.exp(p["A_log"])
    assert ((A >= 1.0) & (A <= 16.0)).all()
