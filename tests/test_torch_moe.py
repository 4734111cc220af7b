"""Port parity: the MoE block (``repro_torch.models.layers.moe_block``)
and its routing, against ``repro.models.layers.moe_block`` on the CPU.

The same numpy inputs and the reference's weights go through both
packages, at the smoke configs' widths (moonshot: 8 experts top-2; kimi:
the same at 4/2 heads; jamba: 4 experts top-2), with swiglu and geglu
experts, at capacity factors 1.25 (assignments dropped) and 8.0 (none),
at T = 80 (a prefill) and T = 1 (a decode step).

- Routing (experts, queue places, keep mask) exactly, given the
  reference's router logits: the reference's lines (softmax, ``top_k``,
  the ``cumsum`` over the flattened one-hot, ``keep``) run in jnp on the
  same f32 logits the port's ``moe_route`` takes.
- The block's output and aux loss in f32 at atol 1e-4 (measured: under
  1e-6; the port adds each token's K expert outputs in another order).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import get_arch
from repro_torch.models import layers as tl

F32_TOL = 1e-4
CASES = [(arch, mlp, cf, T)
         for arch in ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b",
                      "jamba-1.5-large-398b")
         for mlp in ("swiglu", "geglu")
         for cf in (1.25, 8.0)
         for T in (80, 1)]


def _cfgs(arch, mlp, cf):
    j = dataclasses.replace(j_get_arch(arch).smoke, mlp=mlp,
                            capacity_factor=cf)
    t = dataclasses.replace(get_arch(arch).smoke, mlp=mlp,
                            capacity_factor=cf)
    return j, t


def _moe_params(jcfg, seed):
    jp = jt._init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(T, D, seed):
    """Tokens with a shared component, so that the router favours some
    experts (as trained routers are skewed) and capacity 1.25 drops picks."""
    B, S = (2, T // 2) if T > 1 else (1, 1)
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, S, D))
            + 1.5 * rng.normal(0, 1, (D,))).astype(np.float32)


def _ref_routing(logits, K, C):
    """The reference's routing lines (``layers.moe_block``), in jnp."""
    T, E = logits.shape
    gates_all = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(gates_all, K)
    onehot_e = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    flat = onehot_e.reshape(T * K, E)
    pos = jnp.cumsum(flat, axis=0) * flat
    pos_tk = jnp.max(pos.reshape(T, K, E), axis=-1) - 1.0
    keep = (pos_tk >= 0) & (pos_tk < C)
    return (np.array(idx), np.asarray(pos_tk).astype(np.int64),
            np.array(keep))


@pytest.mark.parametrize("arch,mlp,cf,T", CASES)
def test_moe_routing_exact_given_reference_logits(arch, mlp, cf, T):
    jcfg, cfg = _cfgs(arch, mlp, cf)
    jp, _ = _moe_params(jcfg, 1)
    x = _x(T, cfg.d_model, 2).reshape(T, cfg.d_model)
    logits = np.array(jnp.asarray(x) @ jp["router"])
    K, E = cfg.experts_per_token, cfg.n_experts
    C = tl._moe_capacity(T, cfg)
    assert C == min(int(max(4, math.ceil(T * K / E * cf))), T)
    idx, place, keep = _ref_routing(jnp.asarray(logits), K, C)
    _, _, t_idx, t_place, t_keep = tl.moe_route(torch.from_numpy(logits),
                                                K, C)
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    np.testing.assert_array_equal(t_place.numpy(), place)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    if cf == 1.25 and T > 1:
        assert not keep.all()          # the case drops assignments
    if cf == 8.0 or T == 1:
        assert keep.all()


@pytest.mark.parametrize("arch,mlp,cf,T", CASES)
def test_moe_block_matches_reference(arch, mlp, cf, T):
    jcfg, cfg = _cfgs(arch, mlp, cf)
    jp, tp = _moe_params(jcfg, 3)
    x = _x(T, cfg.d_model, 4)
    want, want_aux = jl.moe_block(jp, jnp.asarray(x), jcfg, None)
    got, aux = tl.moe_block(tp, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=F32_TOL,
                               rtol=0)


def test_moe_dispatch_buffer_equals_reference_bits():
    """``moe_dispatch``'s (E, C, D) expert inputs: the reference's one-hot
    einsum adds zeros to each kept row, so the port's copied rows are its
    bits, in bf16 too."""
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b", "swiglu", 1.25)
    jp, tp = _moe_params(jcfg, 5)
    x = _x(80, cfg.d_model, 6).reshape(80, cfg.d_model)
    K, E = cfg.experts_per_token, cfg.n_experts
    C = tl._moe_capacity(80, cfg)
    logits = jnp.asarray(x) @ jp["router"]
    idx, place, keep = _ref_routing(logits, K, C)
    onehot_e = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    onehot_c = jax.nn.one_hot(place, C, dtype=jnp.float32) * keep[..., None]
    dispatch = jnp.einsum("tke,tkc->tec", onehot_e, onehot_c)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        xj = jnp.asarray(x, jdt)
        want = np.asarray(jnp.einsum("td,tec->ecd", xj.astype(jnp.float32),
                                     dispatch).astype(jdt).astype(
                                         jnp.float32))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
        got = tl.moe_dispatch(xt, torch.from_numpy(idx),
                              torch.from_numpy(place),
                              torch.from_numpy(keep), E, C)
        assert got.dtype == tdt and got.shape == (E, C, cfg.d_model)
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_moe_block_bf16_within_a_bf16_step():
    """bf16 compute: outputs within one bf16 step of the reference's at
    their magnitude (the f32 combine of K terms, in another order, rounds
    to bf16 on either side of a step)."""
    jcfg, cfg = _cfgs("kimi-k2-1t-a32b", "swiglu", 1.25)
    jp, tp = _moe_params(jcfg, 7)
    x = jnp.asarray(_x(80, cfg.d_model, 8), jnp.bfloat16)
    want, want_aux = jl.moe_block(jp, x, jcfg, None)
    got, aux = tl.moe_block(
        tp, torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16(),
        cfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - want) <= step + 1e-6).all()
    np.testing.assert_allclose(float(aux), float(want_aux), atol=F32_TOL)
