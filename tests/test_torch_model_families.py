"""Port parity: the LM's other families through ``apply_model`` and the
serving steps — MoE (moonshot, kimi with its dense prefix), VLM with
M-RoPE (qwen2-vl, embeddings in), SSM (mamba2), hybrid (jamba) and the
audio encoder (hubert, embeddings in, not causal) — at their smoke
configs, against ``repro.models.transformer`` on the CPU.

The same numpy inputs and the reference's weights (carried by
``convert.params_from_jax``) go through both packages. Tolerances:
- f32: logits, aux and caches at atol 1e-4 (measured: at most 1.2e-6 on
  the logits), MoE routing (experts and keep mask of every token in every
  MoE layer) identical;
- bf16: atol 1.5e-2 on the logits, as ``tests/test_torch_models.py``
  holds the dense four. Routing is discrete: where the two packages'
  bf16 router logits straddle a near-tie, a token picks another expert
  (measured: one or two tokens of 80 in a layer of moonshot, kimi and
  jamba, at gate margins under 2e-3) and its output moves by far more
  than the tolerance (up to 0.16). Such a token is allowed only at a
  margin the gates' drift explains, only for few tokens, and the logits
  it reaches (itself; with a mixing layer after it, every later position
  of its sequence) are left out of the comparison; at least half the
  rows stay in it (measured: the rest within 1.22e-2, jamba; the others
  under 8.1e-3).
  Greedy tokens are compared where the reference's top-1 / top-2 margin
  exceeds twice the tolerance and no routing difference reaches;
- prefill/decode continuity at 2e-3, as ``tests/test_models.py`` holds
  the reference.
The CPU path runs kernel 5's plain version: its launch count stays 0.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        params_from_jax)
from repro_torch.train import serve_step as tss

FAMILIES = ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "qwen2-vl-2b",
            "mamba2-130m", "jamba-1.5-large-398b", "hubert-xlarge"]
DECODING = [a for a in FAMILIES if a != "hubert-xlarge"]
KEY = jax.random.PRNGKey(0)
B, S, GEN = 2, 40, 6
F32_TOL, BF16_TOL = 1e-4, 1.5e-2
_RUNS = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def vl_pos3(B_, S_):
    """qwen2-vl position streams (t, h, w) of a text run, a 4 x 4 image
    grid (t constant, h and w over the grid) and text again, each text
    position one past the largest before it."""
    n_text, grid = 8, 4
    t, h, w = [], [], []
    for i in range(n_text):
        t.append(i), h.append(i), w.append(i)
    for r in range(grid):
        for c in range(grid):
            t.append(n_text), h.append(n_text + r), w.append(n_text + c)
    nxt = n_text + grid
    while len(t) < S_:
        t.append(nxt), h.append(nxt), w.append(nxt)
        nxt += 1
    p = np.stack([np.asarray(v[:S_]) for v in (t, h, w)]).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(p[:, None], (3, B_, S_)))


def _inputs(cfg, seed):
    """(prefill batch, decode inputs: GEN - 1 embedding rows where the
    model takes embeddings, else None) as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.embed_input:
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (B, S)).astype(np.int32)}
        steps = None
    else:
        batch = {"embeds": rng.normal(0, 1, (B, S, cfg.d_model)).astype(
            np.float32)}
        steps = rng.normal(0, 1, (B, GEN - 1, cfg.d_model)).astype(
            np.float32)
    if cfg.m_rope:
        batch["pos3"] = vl_pos3(B, S)
    return batch, steps


# --------------------------------------------------------------- routing

@contextlib.contextmanager
def routes():
    """Record each MoE layer's routing in both packages, in call order:
    the port's ``moe_route`` (softmax gates, picks, keep mask) and the
    reference's ``jax.lax.top_k`` on its gates (an ordered debug
    callback, so the jitted steps traced inside record too)."""
    port, ref = [], []
    orig_route, orig_top = tl.moe_route, jax.lax.top_k

    def port_route(logits, K, C):
        r = orig_route(logits, K, C)
        port.append((r[0].numpy(), r[2].numpy(), r[4].numpy()))
        return r

    def ref_top(x, k):
        v, i = orig_top(x, k)
        jax.debug.callback(lambda a, b: ref.append((np.asarray(a),
                                                    np.asarray(b))),
                           x, i, ordered=True)
        return v, i

    tl.moe_route, jax.lax.top_k = port_route, ref_top
    try:
        yield port, ref
    finally:
        tl.moe_route, jax.lax.top_k = orig_route, orig_top


def _ref_keep(idx, C):
    """The reference's keep mask from its picks (t-major queue order)."""
    T, K = idx.shape
    flat = idx.reshape(-1)
    place = np.zeros_like(flat)
    count = {}
    for n, e in enumerate(flat):
        place[n] = count.get(e, 0)
        count[e] = place[n] + 1
    return (place < C).reshape(T, K)


def routing_differences(cfg, port, ref, T):
    """Tokens (0..T-1) each MoE layer routed differently, layer by layer
    (MoE layers in order). A token picks other experts only at a near-tie
    of the reference's gates that the two packages' gate drift explains;
    a keep mask differs only after such a token in that layer."""
    assert len(port) == len(ref) == len(_moe_layers(cfg))
    if not port:
        return []
    K = cfg.experts_per_token
    C = tl._moe_capacity(T, cfg)
    out, n_picks = [], 0
    for (pg, pi, pk), (rg, ri) in zip(port, ref):
        picks = (np.sort(pi, -1) != np.sort(ri, -1)).any(-1)
        keeps = (pk != _ref_keep(ri, C)).any(-1) & ~picks
        for t in np.nonzero(picks)[0]:
            srt = np.sort(rg[t])[::-1]
            drift = np.abs(pg[t] - rg[t]).max()
            assert srt[K - 1] - srt[K] <= 2 * drift + 1e-7, \
                (t, srt[K - 1] - srt[K], drift)
        if keeps.any():
            assert picks.any() and \
                np.nonzero(keeps)[0].min() > np.nonzero(picks)[0].min()
        out.append(picks | keeps)
        n_picks += int(picks.sum())
    assert n_picks <= max(2, T // 20)
    return out


def _moe_layers(cfg):
    return [i for i, k in enumerate(tt.layer_kinds(cfg))
            if k.endswith("_moe")]


def reached_prefill(cfg, diffs):
    """The (B, S) mask of the logits a routing difference reaches (its own
    position, and every later one of its sequence when a mixing layer,
    attention or mamba, follows its layer), and the (B,) mask of the
    sequences whose cache it reaches (the same condition)."""
    mask = np.zeros((B, S), bool)
    tainted = np.zeros(B, bool)
    for layer, d in zip(_moe_layers(cfg), diffs):
        for t in np.nonzero(d)[0]:
            b, s = divmod(int(t), S)
            if layer < cfg.n_layers - 1:
                mask[b, s:] = tainted[b] = True
            else:
                mask[b, s] = True
    return mask, tainted


def reached_steps(cfg, prefill_mask, tainted, step_diffs):
    """(B, GEN) mask over the last prefill logits and the decode steps: a
    sequence is reached from a step on by a difference in that step, or
    by one in an earlier call that reached its cache."""
    mask = np.zeros((B, GEN), bool)
    mask[:, 0] = prefill_mask[:, -1]
    tainted = tainted.copy()
    for i in range(1, GEN):
        mask[:, i] |= tainted
        for layer, d in zip(_moe_layers(cfg), step_diffs[i]):
            for b in np.nonzero(d)[0]:
                mask[b, i] = True
                if layer < cfg.n_layers - 1:
                    tainted[b] = True
    return mask


# ------------------------------------------------------------ reference

def _take(ref):
    jax.effects_barrier()
    out = list(ref)
    ref.clear()
    return out


def _ref_run(arch, dtype, cfg=None):
    """The reference's outputs for one config at one compute and cache
    type, jitted: the no-cache logits and aux, the prefill's logits and
    cache, and, for a model that decodes, GEN - 1 decode steps fed its own
    greedy tokens (or the given embedding rows), with each call's routing
    (``routes``)."""
    jcfg = cfg or j_get_arch(arch).smoke
    params = jt.init_params(jcfg, KEY)
    batch, steps = _inputs(jcfg, len(arch))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    r = {"params": params, "batch": batch, "steps": steps}
    with routes() as (_, ref):
        step = jax.jit(lambda p, b, c, mode: jt.apply_model(
            p, jcfg, b, cache=c, logits_mode=mode, compute_dtype=dtype),
            static_argnums=3)
        logits, _, aux = step(params, jb, None, "all")
        r.update(logits=np.asarray(logits), aux=float(aux),
                 routes=_take(ref))
        if not jcfg.has_decode:
            return r
        cache = jt.init_cache(jcfg, B, S + GEN, dtype=dtype)
        logits, cache, _ = step(params, jb, cache, "last")
        _take(ref)
        r["cache"] = jax.tree.map(np.asarray, cache)
        out, all_logits, step_routes = [], [logits], []
        for i in range(GEN - 1):
            pos = jnp.full((B,), S + i, jnp.int32)
            if jcfg.embed_input:
                out.append(jnp.argmax(logits, -1).astype(jnp.int32))
                b = {"tokens": out[-1][:, None]}
            else:
                b = {"embeds": jnp.asarray(steps[:, i:i + 1])}
            b["positions"] = pos[:, None]
            if jcfg.m_rope:
                b["pos3"] = jnp.broadcast_to(pos[None, :, None], (3, B, 1))
            logits, cache, _ = step(params, b, cache, "last")
            step_routes.append(_take(ref))
            all_logits.append(logits)
        if jcfg.embed_input:
            out.append(jnp.argmax(logits, -1).astype(jnp.int32))
            r["tokens"] = np.stack([np.asarray(o) for o in out], 1)
        r["step_logits"] = np.stack([np.asarray(x) for x in all_logits], 1)
        r["step_routes"] = step_routes
    return r


def _runs(arch):
    if arch not in _RUNS:
        _RUNS[arch] = {"f32": _ref_run(arch, jnp.float32),
                       "bf16": _ref_run(arch, jnp.bfloat16)}
    return _RUNS[arch]


def _port(arch, run):
    cfg = get_arch(arch).smoke
    return cfg, params_from_jax(jax.tree.map(np.asarray, run["params"]),
                                cfg, device="cpu")


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


# ------------------------------------------------------------ apply_model

@pytest.mark.parametrize("arch", FAMILIES)
def test_apply_model_f32_logits_aux_cache_and_steps(arch):
    r = _runs(arch)["f32"]
    cfg, params = _port(arch, r)
    flash_ops.launches = 0
    with routes() as (port, _):
        got, cache, aux = tt.apply_model(params, cfg, _tbatch(r["batch"]),
                                         compute_dtype=torch.float32)
        C = tl._moe_capacity(B * S, cfg) if cfg.n_experts else 0
        for (_, pi, pk), (_, ri) in zip(port, r["routes"]):
            np.testing.assert_array_equal(pi, ri)
            np.testing.assert_array_equal(pk, _ref_keep(ri, C))
    assert len(port) == len(r["routes"]) == len(_moe_layers(cfg))
    assert cache is None and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), r["logits"], atol=F32_TOL)
    np.testing.assert_allclose(float(aux), r["aux"], atol=F32_TOL)
    assert (float(aux) > 0) == (cfg.n_experts > 0)
    if not cfg.has_decode:
        assert flash_ops.launches == 0
        return

    # the prefill's cache, layer by layer, then the decode steps
    cache = tt.init_cache(cfg, B, S + GEN, dtype=torch.float32, device="cpu")
    logits, cache, _ = tt.apply_model(params, cfg, _tbatch(r["batch"]),
                                      cache=cache, logits_mode="last",
                                      compute_dtype=torch.float32)
    want = cache_to_numpy(cache_from_jax(r["cache"], cfg, device="cpu"))
    got_c = cache_to_numpy(cache)
    assert len(got_c) == cfg.n_layers
    for i, (g, w) in enumerate(zip(got_c, want)):
        assert set(g) == set(w), i
        for name in w:
            assert g[name].dtype == w[name].dtype, (i, name)
            np.testing.assert_allclose(g[name], w[name], atol=F32_TOL,
                                       err_msg=f"layer {i} {name}")
    steps = [logits]
    for i in range(GEN - 1):
        pos = torch.full((B, 1), S + i, dtype=torch.int32)
        if cfg.embed_input:
            b = {"tokens": _t(r["tokens"][:, i:i + 1])}
        else:
            b = {"embeds": _t(r["steps"][:, i:i + 1])}
        b["positions"] = pos
        if cfg.m_rope:
            b["pos3"] = pos[None].expand(3, B, 1)
        logits, cache, _ = tt.apply_model(params, cfg, b, cache=cache,
                                          logits_mode="last",
                                          compute_dtype=torch.float32)
        steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               r["step_logits"], atol=F32_TOL)
    if cfg.embed_input:
        np.testing.assert_array_equal(torch.stack(steps, 1).argmax(-1)
                                      .numpy(), r["tokens"])
    assert flash_ops.launches == 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_apply_model_bf16_and_serving_steps(arch):
    r = _runs(arch)["bf16"]
    cfg, params = _port(arch, r)
    with routes() as (port, _):
        got, _, aux = tt.apply_model(params, cfg, _tbatch(r["batch"]))
        diffs = routing_differences(cfg, port, r["routes"], B * S)
    reached, tainted = reached_prefill(cfg, diffs)
    assert reached.mean() <= 0.5
    np.testing.assert_allclose(got.numpy()[~reached], r["logits"][~reached],
                               atol=BF16_TOL)
    np.testing.assert_allclose(float(aux), r["aux"], atol=BF16_TOL)
    if not cfg.has_decode:
        return

    # teacher-forced: the port's serving steps fed the reference's tokens
    # (or the same embedding rows)
    want_logits = r["step_logits"]
    prefill = tss.make_prefill_step(cfg, max_len=S + GEN)
    decode = tss.make_decode_step(cfg)
    with routes() as (port, _):
        logits, cache = prefill(params, _tbatch(r["batch"]))
        port.clear()
        steps, step_diffs = [logits], [[]]
        for i in range(GEN - 1):
            x = (_t(r["tokens"][:, i]) if cfg.embed_input
                 else _t(r["steps"][:, i]))
            logits, cache = decode(params, cache, x,
                                   torch.full((B,), S + i, dtype=torch.int32))
            steps.append(logits)
            step_diffs.append(routing_differences(cfg, port,
                                                  r["step_routes"][i], B))
            port.clear()
    reached = reached_steps(cfg, reached, tainted, step_diffs)
    assert reached.mean() <= 0.5
    steps = torch.stack(steps, 1).numpy()
    np.testing.assert_allclose(steps[~reached], want_logits[~reached],
                               atol=BF16_TOL)
    if not cfg.embed_input:
        return
    want_toks = r["tokens"]
    top2 = np.sort(want_logits, -1)[..., -2:]
    sure = ((top2[..., 1] - top2[..., 0]) > 2 * BF16_TOL) & ~reached
    assert sure.sum() >= 2
    np.testing.assert_array_equal(steps.argmax(-1)[sure], want_toks[sure])

    # free-running greedy_generate: each row up to its first unsure step
    tokens = tss.greedy_generate(cfg, params, _t(r["batch"]["tokens"]),
                                 steps=GEN, max_len=S + GEN).numpy()
    assert tokens.shape == (B, GEN) and tokens.dtype == np.int32
    assert ((tokens >= 0) & (tokens < cfg.vocab_size)).all()
    for b in range(B):
        upto = int(np.argmin(sure[b])) if not sure[b].all() else GEN
        np.testing.assert_array_equal(tokens[b, :upto], want_toks[b, :upto])


def test_vlm_prefill_cache_holds_plain_rope_keys():
    """qwen2-vl's prefill attends with M-RoPE but caches keys rotated by
    the plain RoPE on ``positions``, as the reference's
    ``_prefill_attn_cache`` does; decode steps write M-RoPE keys."""
    arch = "qwen2-vl-2b"
    r = _runs(arch)["f32"]
    cfg, params = _port(arch, r)
    batch = _tbatch(r["batch"])
    cache = tt.init_cache(cfg, B, S + GEN, dtype=torch.float32, device="cpu")
    _, cache, _ = tt.apply_model(params, cfg, batch, cache=cache,
                                 compute_dtype=torch.float32)
    want = r["cache"]["blocks"]["l0"]["k"][0]
    np.testing.assert_allclose(cache["layers"][0]["k"][:, :S].numpy(),
                               want[:, :S], atol=F32_TOL)
    p = params["layers"][0]
    x = tl.rms_norm(batch["embeds"], p["norm1"], cfg.rms_eps)
    k = x @ p["attn"]["wk"]
    if cfg.qkv_bias:
        k = k + p["attn"]["bk"]
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    plain = tl.apply_rope(k, pos, cfg.rope_theta)
    m = tl.apply_m_rope(k, batch["pos3"], cfg.m_rope_sections,
                        cfg.rope_theta)
    np.testing.assert_allclose(cache["layers"][0]["k"][:, :S].numpy(),
                               plain.numpy(), atol=F32_TOL)
    assert (m - plain).abs().max() > 0.1      # the image grid's keys differ


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_apply_m_rope_matches(sections):
    hd = 2 * sum(sections)
    rng = np.random.default_rng(hd)
    x = rng.normal(0, 1, (2, 40, 3, hd)).astype(np.float32)
    pos3 = vl_pos3(2, 40)
    for theta in (1e4, 1e6):
        want = jl.apply_m_rope(jnp.asarray(x), jnp.asarray(pos3), sections,
                               theta)
        got = tl.apply_m_rope(_t(x), _t(pos3), sections, theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("arch", DECODING)
def test_one_token_prompt_with_a_cache_is_a_decode(arch):
    """A prompt of one token with a fresh cache takes the decode branch
    (the reference's ``decode = cache is not None and S == 1``), mamba
    layers too: logits and the cache it leaves."""
    r = _runs(arch)["f32"]
    jcfg = j_get_arch(arch).smoke
    cfg, params = _port(arch, r)
    batch = {k: (v[:, :, :1] if k == "pos3" else v[:, :1])
             for k, v in r["batch"].items()}
    jc = jt.init_cache(jcfg, B, 8, dtype=jnp.float32)
    want, jc, _ = jt.apply_model(r["params"], jcfg,
                                 {k: jnp.asarray(v) for k, v in
                                  batch.items()}, cache=jc,
                                 logits_mode="last",
                                 compute_dtype=jnp.float32)
    tc = tt.init_cache(cfg, B, 8, dtype=torch.float32, device="cpu")
    got, tc, _ = tt.apply_model(params, cfg, _tbatch(batch), cache=tc,
                                logits_mode="last",
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    want_c = cache_to_numpy(cache_from_jax(jax.tree.map(np.asarray, jc), cfg,
                                           device="cpu"))
    for g, w in zip(cache_to_numpy(tc), want_c):
        for name in w:
            np.testing.assert_allclose(g[name], w[name], atol=F32_TOL)


# ------------------------------------------------------------- continuity

@pytest.mark.parametrize("arch,cf", [("mamba2-130m", None),
                                     ("jamba-1.5-large-398b", 8.0),
                                     ("kimi-k2-1t-a32b", 8.0)])
def test_prefill_decode_continuity(arch, cf):
    """At capacity 8.0 no MoE layer drops a pick (a prefill of N tokens
    could drop what one decode step keeps)."""
    cfg = get_arch(arch).smoke
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    params = tt.init_params(cfg, 0, device="cpu")
    toks = _t(np.random.default_rng(9).integers(0, cfg.vocab_size,
                                                (B, 24)).astype(np.int32))
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

def _leaves(p):
    return jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), p))


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_and_carry_shapes_and_scales(arch):
    jcfg, cfg = j_get_arch(arch).smoke, get_arch(arch).smoke
    jp = jt.init_params(jcfg, KEY)
    carried = params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                              device="cpu")
    assert len(carried["layers"]) == cfg.n_layers
    assert ("embed" in carried) == cfg.embed_input
    assert ("head" in carried) == (not cfg.tie_embeddings)
    a = tt.init_params(cfg, 3, device="cpu")
    b = tt.init_params(cfg, 3, device="cpu")
    c = tt.init_params(cfg, 4, device="cpu")
    fa, fc = _leaves(a), _leaves(carried)
    assert [k for k, _ in fa] == [k for k, _ in fc]
    for (path, x), (_, y) in zip(fa, fc):
        assert x.shape == y.shape and x.dtype == y.dtype == np.float32, path
        if y.std() > 0 and y.size >= 64:   # the reference's draw's scale
            assert 0.75 < x.std() / y.std() < 1.33, path
        elif y.std() > 0:                  # a few values: the same range
            lo, hi = y.min() - 3 * y.std(), y.max() + 3 * y.std()
            assert lo <= x.min() and x.max() <= hi, path
        else:
            np.testing.assert_array_equal(x, y, err_msg=str(path))
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    assert not all(torch.equal(x, y) for x, y in
                   zip(jax.tree.leaves(a), jax.tree.leaves(c)))
    # the dense-FF rule: kimi's prefix at d_ff_dense, jamba's mamba
    # layers at d_ff
    for kind, layer in zip(tt.layer_kinds(cfg), a["layers"]):
        if "mlp" in layer:
            assert layer["mlp"]["w_up"].shape[1] == \
                (cfg.d_ff_dense or cfg.d_ff), kind
        assert ("moe" in layer) == kind.endswith("_moe")
        assert ("mamba" in layer) == kind.startswith("mamba")


# ----------------------------------------------------------- the launcher

@pytest.mark.parametrize("arch", ["mamba2-130m", "moonshot-v1-16b-a3b",
                                  "kimi-k2-1t-a32b", "jamba-1.5-large-398b"])
def test_serve_smoke_runs_every_decoding_family(arch, capsys):
    flash_ops.launches = 0
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("prefill 2x20: ") and "ms/tok" in lines[0]
    assert lines[1].startswith("sample tokens: [")
    V = get_arch(arch).smoke.vocab_size
    assert res["tokens"].shape == (2, 4) and res["logits"].shape == (2, V)
    assert torch.isfinite(res["logits"]).all()
    assert ((res["tokens"] >= 0) & (res["tokens"] < V)).all()
    assert flash_ops.launches == 0
