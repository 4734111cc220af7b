"""Port parity: the training step (``repro_torch.train.train_step``) and the
model's backward pass against ``repro.train`` on the CPU, at every
family's smoke config.

* f32: the port's loss and the gradient of every parameter leaf, for
  ``loss_fn`` at f32 compute, against ``jax.value_and_grad`` of the
  reference's ``apply_model(..., compute_dtype=jnp.float32)`` followed by
  its ``cross_entropy`` (+ 0.01 · aux), composed here. Parameters go
  through ``params_from_jax``. Loss within 1e-5 relative; each leaf's
  gradient within 2e-5 of that leaf's norm (the norm of the difference;
  measured: at most 5.1e-6, jamba) plus 1e-7 for leaves whose gradient is
  near zero.
* bf16: ``make_train_step(microbatches=2)`` over 3 steps from the same
  state (``train_state_from_jax``) against the reference's jitted step:
  each step's loss within 2e-3 (measured: at most 1.02e-3, kimi; one
  bf16 rounding of the logits averages down over the tokens, and Adam's
  steps of size lr move the two trajectories apart by little), grad
  norms within 2 % (measured: 0.51 %, jamba), and the loss falls, as the
  reference's ``test_train_loss_decreases`` asks.
* The MoE dispatch's backward: a dropped pick gets exactly zero gradient
  and a kept pick exactly its expert row's; remat on and off give the
  same step bit for bit, and a recompute routes as its forward did.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jt
from repro.train import train_step as jts
from repro.train.optimizer import AdamWConfig as JAdamW
from repro_torch.configs import get_arch
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (params_from_jax, train_state_from_jax,
                                        train_state_to_numpy)
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

FAMILIES = ["gemma-2b", "h2o-danube-3-4b", "llama3.2-1b",
            "kimi-k2-1t-a32b", "moonshot-v1-16b-a3b", "mamba2-130m",
            "jamba-1.5-large-398b", "qwen2-vl-2b", "hubert-xlarge"]
TRAINED = ["gemma-2b", "jamba-1.5-large-398b", "mamba2-130m",
           "kimi-k2-1t-a32b", "hubert-xlarge", "qwen2-vl-2b"]
KEY = jax.random.PRNGKey(0)
B, S = 2, 32
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-5, 1e-7
BF16_LOSS_ATOL, BF16_NORM_RTOL = 2e-3, 2e-2


def vl_pos3(b, s):
    """A text run, a 4 x 4 image grid (t fixed, h and w over the grid) and
    text again, each text position one past the largest before it."""
    t = list(range(8)) + [8] * 16
    h = list(range(8)) + [8 + r for r in range(4) for _ in range(4)]
    w = list(range(8)) + [8 + c for _ in range(4) for c in range(4)]
    nxt = 12
    while len(t) < s:
        t.append(nxt), h.append(nxt), w.append(nxt)
        nxt += 1
    p = np.stack([np.asarray(x[:s]) for x in (t, h, w)]).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(p[:, None], (3, b, s)))


def make_batch(cfg, seed=1, b=B, s=S):
    """numpy inputs for both packages: tokens or embeddings, labels, and
    the M-RoPE streams where the model has them."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32)}
    if cfg.embed_input:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)
                                       ).astype(np.int32)
    else:
        batch["embeds"] = rng.normal(0, 1, (b, s, cfg.d_model)
                                     ).astype(np.float32)
    if cfg.m_rope:
        batch["pos3"] = vl_pos3(b, s)
    return batch


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", FAMILIES)
def test_f32_loss_and_gradients_match_reference(arch):
    jcfg, cfg = j_get_arch(arch).smoke, get_arch(arch).smoke
    jparams = jt.init_params(jcfg, KEY)
    batch = make_batch(cfg)

    def jloss(p):
        logits, _, aux = jt.apply_model(p, jcfg, _j(batch),
                                        compute_dtype=jnp.float32)
        if jcfg.causal:
            ce = jts.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
        else:
            ce = jts.cross_entropy(logits, batch["labels"])
        return ce + 0.01 * aux

    want, jgrads = jax.value_and_grad(jloss)(jparams)
    params = params_from_jax(_np(jparams), cfg, "cpu")
    leaves = [p.requires_grad_() for p in topt.tree_leaves(params)]
    total, _ = tts.loss_fn(params, cfg, _t(batch),
                           compute_dtype=torch.float32)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(want),
                               rtol=LOSS_RTOL)
    wants = topt.tree_leaves(params_from_jax(_np(jgrads), cfg, "cpu"))
    assert len(wants) == len(leaves)
    for p, w in zip(leaves, wants):
        assert p.grad is not None and p.grad.shape == w.shape
        err = float((p.grad - w).norm())
        assert err <= GRAD_RTOL * float(w.norm()) + GRAD_ATOL, \
            (p.shape, err, float(w.norm()))


@pytest.mark.parametrize("arch", TRAINED)
def test_bf16_train_steps_match_reference(arch):
    jcfg, cfg = j_get_arch(arch).smoke, get_arch(arch).smoke
    jstate = jts.init_state(jcfg, KEY)
    state = train_state_from_jax(_np(jstate), cfg, "cpu")
    batch = make_batch(cfg, seed=2)
    jstep = jax.jit(jts.make_train_step(jcfg, JAdamW(lr=1e-3),
                                        microbatches=2))
    step = tts.make_train_step(cfg, topt.AdamWConfig(lr=1e-3),
                               microbatches=2)
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, _j(batch))
        state, m = step(state, _t(batch))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= BF16_LOSS_ATOL
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=BF16_NORM_RTOL)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert int(state.step) == 3 and int(state.opt.count) == 3


def test_train_state_round_trip():
    cfg = get_arch("kimi-k2-1t-a32b").smoke
    jstate = _np(jts.init_state(j_get_arch("kimi-k2-1t-a32b").smoke, KEY))
    state = train_state_from_jax(jstate, cfg, "cpu")
    back = train_state_to_numpy(state)
    assert isinstance(back, tts.TrainState)
    want = params_from_jax(jstate.params, cfg, "cpu")
    for a, b in zip(topt.tree_leaves(back.params), topt.tree_leaves(want)):
        assert isinstance(a, np.ndarray) and np.array_equal(a, b.numpy())
    assert len(topt.tree_leaves(back.opt.m)) == \
        len(topt.tree_leaves(state.params))
    assert int(back.opt.count) == 0 and int(back.step) == 0


def test_moe_dispatch_gradient_exact():
    """Row (e, c) of the experts' input is token t's row for each kept pick
    (t, e) at place c: its gradient flows back to t exactly, and a
    dropped pick (its write goes to the spare last row) gets nothing."""
    rng = np.random.default_rng(3)
    T, D, E, C, K = 12, 5, 3, 2, 2
    logits = torch.from_numpy(rng.normal(size=(T, E)).astype(np.float32))
    _, _, idx, place, keep = tl.moe_route(logits, K, C)
    assert bool((~keep).any()) and bool(keep.any())
    xt = torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32)
                          ).requires_grad_()
    xe = tl.moe_dispatch(xt, idx, place, keep, E, C)
    gy = torch.from_numpy(rng.normal(size=(E, C, D)).astype(np.float32))
    xe.backward(gy)
    want = torch.zeros((T, D))
    for t in range(T):
        for k in range(K):
            if keep[t, k]:
                want[t] += gy[idx[t, k], place[t, k]]
    assert torch.equal(xt.grad, want)
    dropped = (~keep).all(1)
    if bool(dropped.any()):
        assert bool((xt.grad[dropped] == 0).all())


def test_moe_combine_gradient_skips_dropped_picks():
    rng = np.random.default_rng(4)
    T, D, E, C, K = 10, 4, 3, 2, 2
    logits = torch.from_numpy(rng.normal(size=(T, E)).astype(np.float32))
    _, gate_vals, idx, place, keep = tl.moe_route(logits, K, C)
    gate_vals = gate_vals.clone().requires_grad_()
    ye = torch.from_numpy(rng.normal(size=(E, C, D)).astype(np.float32)
                          ).requires_grad_()
    y = tl.moe_combine(ye, gate_vals, idx, place, keep)
    y.backward(torch.ones_like(y))
    assert bool((gate_vals.grad[~keep] == 0).all())
    assert bool((gate_vals.grad[keep] != 0).all())
    used = torch.zeros((E * C,), dtype=torch.bool)
    used[(idx * C + place)[keep]] = True
    grad_rows = ye.grad.reshape(E * C, D)
    assert bool((grad_rows[~used] == 0).all())


def _one_step(cfg, batch, **kw):
    state = tts.init_state(cfg, 0, device="cpu")
    step = tts.make_train_step(cfg, topt.AdamWConfig(lr=1e-3), **kw)
    return step(state, _t(batch))


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "h2o-danube-3-4b"])
def test_remat_on_and_off_equal(arch, monkeypatch):
    """Checkpointed layers recompute the same values, so the step is the
    same bit for bit; the MoE routes each recompute as its forward did."""
    cfg = get_arch(arch).smoke
    assert cfg.remat
    batch = make_batch(cfg, seed=5, b=4)
    routes = []
    real = tl.moe_route

    def record(logits, K, C):
        out = real(logits, K, C)
        routes.append((out[2].clone(), out[3].clone()))
        return out
    monkeypatch.setattr(tl, "moe_route", record)
    on, m_on = _one_step(cfg, batch, microbatches=2)
    n_on = len(routes)
    off, m_off = _one_step(dataclasses.replace(cfg, remat=False), batch,
                           microbatches=2)
    for a, b in zip(topt.tree_leaves(on), topt.tree_leaves(off)):
        assert torch.equal(a, b)
    assert float(m_on["loss"]) == float(m_off["loss"])
    if cfg.n_experts:
        n_moe = sum(k.endswith("_moe") for k in tt.layer_kinds(cfg))
        # with remat each microbatch routes every MoE layer forward, then
        # again in its backward, last layer first; without, forward only
        assert n_on == 2 * 2 * n_moe and len(routes) == n_on + 2 * n_moe
        for mb in range(2):
            fwd = routes[2 * n_moe * mb:2 * n_moe * mb + n_moe]
            rec = routes[2 * n_moe * mb + n_moe:2 * n_moe * (mb + 1)]
            for (i1, p1), (i2, p2) in zip(fwd, rec[::-1]):
                assert torch.equal(i1, i2) and torch.equal(p1, p2)


def test_micro_split_and_pos3():
    x = torch.arange(24).reshape(4, 6)
    p3 = torch.arange(72).reshape(3, 4, 6)
    a = tts.split_micro("tokens", x, 2)
    b = tts.split_micro("pos3", p3, 2)
    assert [t.shape for t in a] == [(2, 6), (2, 6)]
    assert [t.shape for t in b] == [(3, 2, 6), (3, 2, 6)]
    assert torch.equal(b[1], p3[:, 2:])
    with pytest.raises(ValueError):
        tts.split_micro("tokens", x, 3)


def test_cross_entropy_matches_reference_and_ignores():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 3, (2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    labels[0, 2] = labels[1, 5] = -1
    want = jts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tts.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = tts.cross_entropy(torch.from_numpy(logits),
                             torch.full((2, 7), -1))
    assert float(none) == 0.0
