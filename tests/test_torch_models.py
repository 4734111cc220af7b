"""Port parity: the LM's layers, ``apply_model``, the serving steps and the
weight carry, for the four dense attention configs at smoke size (the
other families: ``tests/test_torch_model_families.py``).

The same numpy inputs and the reference's weights (carried by
``repro_torch.models.convert.params_from_jax``) go through both packages.
Tolerances:
- layers and ``apply_model`` in f32: atol 1e-4 (measured: under 1e-6 on
  logits of magnitude < 1; the two sum f32 products in other orders);
- ``apply_model`` in bf16: atol 1.5e-2 on the logits (measured: at most
  7.8e-3 over the four configs; bf16 rounds at other places in XLA and
  torch); greedy tokens are compared where the top-1 / top-2 margin of the
  reference exceeds twice that;
- prefill/decode continuity at 2e-3, as ``tests/test_models.py`` holds the
  reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import get_arch
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_jax
from repro_torch.train import serve_step as tss

DENSE = ["gemma-2b", "qwen1.5-0.5b", "llama3.2-1b", "h2o-danube-3-4b"]
KEY = jax.random.PRNGKey(0)
B, S, GEN = 2, 40, 6
F32_TOL, BF16_TOL = 1e-4, 1.5e-2
_RUNS = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def _greedy_jax(cfg, params, toks, dtype):
    """The reference's greedy loop (``serve_step.greedy_generate``) at a
    chosen compute and cache type, jitted; returns the prefill's logits at
    every position, the cache after prefill, and the tokens and the logits
    each token was drawn from."""
    def step(p, batch, cache, mode):
        return jt.apply_model(p, cfg, batch, cache=cache, logits_mode=mode,
                              compute_dtype=dtype)[:2]
    step = jax.jit(step, static_argnums=3)
    cache = jt.init_cache(cfg, B, S + GEN, dtype=dtype)
    logits, cache = step(params, {"tokens": toks}, cache, "all")
    prefill_logits = np.asarray(logits)
    prefill_cache = jax.tree.map(np.asarray, cache)
    logits = logits[:, -1]
    out, all_logits = [jnp.argmax(logits, -1).astype(jnp.int32)], [logits]
    for i in range(GEN - 1):
        pos = jnp.full((B, 1), S + i, jnp.int32)
        logits, cache = step(params, {"tokens": out[-1][:, None],
                                      "positions": pos}, cache, "last")
        out.append(jnp.argmax(logits, -1).astype(jnp.int32))
        all_logits.append(logits)
    return {"logits": prefill_logits, "cache": prefill_cache,
            "tokens": np.stack([np.asarray(o) for o in out], 1),
            "step_logits": np.stack([np.asarray(x) for x in all_logits], 1)}


def _runs(arch):
    """The reference's parameters, inputs and outputs for one config,
    computed once per module."""
    if arch not in _RUNS:
        cfg = j_get_arch(arch).smoke
        params = jt.init_params(cfg, KEY)
        toks = np.random.default_rng(len(arch)).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        r = {"params": params, "toks": toks}
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            r[name] = _greedy_jax(cfg, params, jnp.asarray(toks), dt)
        _RUNS[arch] = r
    return _RUNS[arch]


def _port(arch):
    cfg = get_arch(arch).smoke
    params = params_from_jax(jax.tree.map(np.asarray, _runs(arch)["params"]),
                             cfg, device="cpu")
    return cfg, params


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_copies_equal_the_reference(arch):
    for which in ("config", "smoke"):
        assert dataclasses.asdict(getattr(get_arch(arch), which)) == \
            dataclasses.asdict(getattr(j_get_arch(arch), which))


# ----------------------------------------------------------------- layers

def _rng(seed):
    return np.random.default_rng(seed)


def test_rms_norm_and_rope_match():
    x = _rng(1).normal(0, 1, (2, 9, 4, 16)).astype(np.float32)
    w = _rng(2).normal(0, 0.1, (16,)).astype(np.float32)
    np.testing.assert_allclose(
        tl.rms_norm(_t(x), _t(w)).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=F32_TOL, rtol=0)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    for theta in (1e4, 5e5):
        c, s = tl._rope_angles(_t(pos), 16, theta)
        jc, js = jl._rope_angles(jnp.asarray(pos), 16, theta)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=F32_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=F32_TOL)
        np.testing.assert_allclose(
            tl.apply_rope(_t(x), _t(pos), theta).numpy(),
            np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     theta)), atol=F32_TOL)
    # bf16 x with f32 angles, cast back
    xb = jnp.asarray(x, jnp.bfloat16)
    got = tl.apply_rope(_t(xb.astype(jnp.float32)).bfloat16(), _t(pos), 1e4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jl.apply_rope(xb, jnp.asarray(pos), 1e4), np.float32),
        atol=2e-2)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches(window):
    r = _rng(3)
    q = r.normal(0, 1, (2, 1, 4, 8)).astype(np.float32)
    kc = r.normal(0, 1, (2, 12, 2, 8)).astype(np.float32)
    vc = r.normal(0, 1, (2, 12, 2, 8)).astype(np.float32)
    slot_pos = np.array([list(range(12)), [-1] * 4 + list(range(20, 28))],
                        np.int32)
    cur = np.array([11, 27], np.int32)
    want = jl.decode_attention(*map(jnp.asarray, (q, kc, vc, slot_pos, cur)),
                               scale=0.35, window=window)
    got = tl.decode_attention(*map(_t, (q, kc, vc, slot_pos, cur)),
                              scale=0.35, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_attention_and_mlp_blocks_match(arch):
    cfg, params = _port(arch)
    jcfg = j_get_arch(arch).smoke
    jp = jax.tree.map(lambda a: a[0], _runs(arch)["params"]["blocks"]["l0"])
    x = _rng(4).normal(0, 1, (B, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (B, 11))
    want, _ = jl.attention_block(jp["attn"], jnp.asarray(x),
                                 jnp.asarray(pos), jcfg, None)
    got, _ = tl.attention_block(params["layers"][0]["attn"], _t(x), _t(pos),
                                cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    np.testing.assert_allclose(
        tl.mlp_block(params["layers"][0]["mlp"], _t(x), cfg.mlp).numpy(),
        np.asarray(jl.mlp_block(jp["mlp"], jnp.asarray(x), jcfg.mlp)),
        atol=F32_TOL)
    # one decode step against a ring cache
    W = 7
    cache = {"k": _rng(5).normal(0, 1, (B, W, cfg.n_kv_heads,
                                        cfg.head_dim)).astype(np.float32),
             "v": _rng(6).normal(0, 1, (B, W, cfg.n_kv_heads,
                                        cfg.head_dim)).astype(np.float32),
             "slot_pos": np.array([[7, 8, 2, 3, 4, 5, 6], [-1] * 7],
                                  np.int32)}
    pos1 = np.array([[9], [0]], np.int32)
    want, wc = jl.attention_block(jp["attn"], jnp.asarray(x[:, :1]),
                                  jnp.asarray(pos1), jcfg, None,
                                  cache=jax.tree.map(jnp.asarray, cache))
    tc = {k: _t(v) for k, v in cache.items()}
    got, gc = tl.attention_block(params["layers"][0]["attn"], _t(x[:, :1]),
                                 _t(pos1), cfg, cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(gc[name].numpy(), np.asarray(wc[name]),
                                   atol=F32_TOL)


# ------------------------------------------------------------ apply_model

@pytest.mark.parametrize("arch", DENSE)
def test_apply_model_f32_logits_cache_and_tokens(arch):
    cfg, params = _port(arch)
    r = _runs(arch)
    toks = _t(r["toks"])
    got, cache, aux = tt.apply_model(params, cfg, {"tokens": toks},
                                     compute_dtype=torch.float32)
    assert cache is None and float(aux) == 0.0
    want = r["f32"]
    np.testing.assert_allclose(got.numpy(), want["logits"], atol=F32_TOL)
    last, _, _ = tt.apply_model(params, cfg, {"tokens": toks},
                                logits_mode="last",
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(last.numpy(), want["logits"][:, -1],
                               atol=F32_TOL)

    # the f32 greedy loop: cache after prefill, logits and tokens
    cache = tt.init_cache(cfg, B, S + GEN, dtype=torch.float32, device="cpu")
    logits, cache, _ = tt.apply_model(params, cfg, {"tokens": toks},
                                      cache=cache, logits_mode="last",
                                      compute_dtype=torch.float32)
    for i, layer in enumerate(cache["layers"]):
        ref = jax.tree.map(lambda a: a[i], want["cache"]["blocks"]["l0"])
        for name in ("k", "v", "slot_pos"):
            np.testing.assert_allclose(layer[name].numpy(), ref[name],
                                       atol=F32_TOL)
    out, all_logits = [logits.argmax(-1)], [logits]
    for i in range(GEN - 1):
        pos = torch.full((B, 1), S + i, dtype=torch.int32)
        logits, cache, _ = tt.apply_model(
            params, cfg, {"tokens": out[-1][:, None], "positions": pos},
            cache=cache, logits_mode="last", compute_dtype=torch.float32)
        out.append(logits.argmax(-1))
        all_logits.append(logits)
    np.testing.assert_allclose(torch.stack(all_logits, 1).numpy(),
                               want["step_logits"], atol=F32_TOL)
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(),
                                  want["tokens"])


@pytest.mark.parametrize("arch", DENSE)
def test_apply_model_bf16_and_greedy_generate(arch):
    cfg, params = _port(arch)
    r = _runs(arch)
    got, _, _ = tt.apply_model(params, cfg, {"tokens": _t(r["toks"])})
    np.testing.assert_allclose(got.numpy(), r["bf16"]["logits"],
                               atol=BF16_TOL)
    want_toks, want_logits = r["bf16"]["tokens"], r["bf16"]["step_logits"]
    top2 = np.sort(want_logits, -1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * BF16_TOL
    assert sure.sum() >= 3

    # teacher-forced: the port's serving steps fed the reference's tokens
    prefill = tss.make_prefill_step(cfg, max_len=S + GEN)
    decode = tss.make_decode_step(cfg)
    logits, cache = prefill(params, {"tokens": _t(r["toks"])})
    steps = [logits]
    for i in range(GEN - 1):
        logits, cache = decode(params, cache, _t(want_toks[:, i]),
                               torch.full((B,), S + i, dtype=torch.int32))
        steps.append(logits)
    steps = torch.stack(steps, 1).numpy()
    np.testing.assert_allclose(steps, want_logits, atol=BF16_TOL)
    np.testing.assert_array_equal(steps.argmax(-1)[sure], want_toks[sure])

    # free-running greedy_generate: each row up to its first unsure step
    tokens = tss.greedy_generate(cfg, params, _t(r["toks"]), steps=GEN,
                                 max_len=S + GEN).numpy()
    assert tokens.shape == (B, GEN) and tokens.dtype == np.int32
    assert ((tokens >= 0) & (tokens < cfg.vocab_size)).all()
    for b in range(B):
        upto = int(np.argmin(sure[b])) if not sure[b].all() else GEN
        np.testing.assert_array_equal(tokens[b, :upto], want_toks[b, :upto])


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_continuity(arch):
    cfg, params = _port(arch)
    toks = _t(_rng(9).integers(0, cfg.vocab_size, (B, 24)).astype(np.int32))
    full, _, _ = tt.apply_model(params, cfg, {"tokens": toks},
                                compute_dtype=torch.float32)
    cache = tt.init_cache(cfg, B, 64, dtype=torch.float32, device="cpu")
    _, cache, _ = tt.apply_model(params, cfg, {"tokens": toks[:, :23]},
                                 cache=cache, logits_mode="last",
                                 compute_dtype=torch.float32)
    pos = torch.full((B, 1), 23, dtype=torch.int32)
    dec, _, _ = tt.apply_model(params, cfg, {"tokens": toks[:, 23:24],
                                             "positions": pos}, cache=cache,
                               logits_mode="last",
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), atol=2e-3)


# ------------------------------------------------------------------- init

@pytest.mark.parametrize("arch", DENSE)
def test_init_params_shapes_scales_and_seed(arch):
    cfg, carried = _port(arch)
    a = tt.init_params(cfg, 3, device="cpu")
    b = tt.init_params(cfg, 3, device="cpu")
    c = tt.init_params(cfg, 4, device="cpu")
    flat = lambda p: jax.tree_util.tree_leaves_with_path(  # noqa: E731
        jax.tree.map(lambda t: t.numpy(), p))
    fa, fc = flat(a), flat(carried)
    assert [k for k, _ in fa] == [k for k, _ in fc]
    for (path, x), (_, y) in zip(fa, fc):
        assert x.shape == y.shape and x.dtype == y.dtype == np.float32, path
        if y.std() > 0:                 # same scale as the reference's draw
            assert 0.8 < x.std() / y.std() < 1.25, path
        else:
            assert not x.any(), path
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    assert ("head" in a) == (not cfg.tie_embeddings)
