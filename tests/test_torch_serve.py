"""Port parity: the LM serving path (``repro_torch.launch.serve`` and the
``train.serve_step`` factories it drives).

The serving steps, given the reference's weights, are held against the
reference's steps at the default bf16 compute and cache type, with a
prompt past the sliding window so the ring cache wraps: logits at atol
1.5e-2 (``tests/test_torch_models.py`` measures the bf16 spread), the
cache's slot positions exactly, the first layer's bf16 K/V bit for bit
(the same bf16 products of the same embeddings) and the second layer's at
atol 6e-2 (measured 4.3e-2 on values up to 3.7: the two packages round the
first layer's bf16 output at other places, ~2^-8 relative, and that
carries on). The
launcher runs on ``--device cpu``, raises on ``--device cuda`` without a
card, and refuses an encoder-only model and one that takes embeddings
(``tests/test_torch_model_families.py`` runs the other families).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jt
from repro.train import serve_step as jss
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_jax
from repro_torch.train import serve_step as tss

BF16_TOL = 1.5e-2


def test_serving_steps_match_reference_past_the_window():
    arch, B, S, GEN = "h2o-danube-3-4b", 2, 45, 4
    jcfg, cfg = j_get_arch(arch).smoke, get_arch(arch).smoke
    assert S > cfg.sliding_window            # the ring buffer wraps
    jp = jt.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    j_logits, j_cache = jax.jit(jss.make_prefill_step(jcfg, max_len=S + GEN))(
        jp, {"tokens": jnp.asarray(toks)})
    t_logits, t_cache = tss.make_prefill_step(cfg, max_len=S + GEN)(
        params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=BF16_TOL)
    for i, layer in enumerate(t_cache["layers"]):
        ref = jax.tree.map(lambda a: np.asarray(a[i], np.float32),
                           j_cache["blocks"]["l0"])
        np.testing.assert_array_equal(layer["slot_pos"].numpy(),
                                      ref["slot_pos"])
        for name in ("k", "v"):
            assert layer[name].dtype == torch.bfloat16
            np.testing.assert_allclose(layer[name].float().numpy(),
                                       ref[name], rtol=0,
                                       atol=0 if i == 0 else 6e-2)

    # one decode step from the same token, on each package's cache
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    j_next, _ = jax.jit(jss.make_decode_step(jcfg))(
        jp, j_cache, jnp.asarray(tok), jnp.asarray(pos))
    t_next, _ = tss.make_decode_step(cfg)(params, t_cache,
                                          torch.from_numpy(tok),
                                          torch.from_numpy(pos))
    np.testing.assert_allclose(t_next.numpy(), np.asarray(j_next),
                               atol=BF16_TOL)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma-2b"])
def test_serve_smoke_runs_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40", "--gen", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("prefill 2x40: ") and "ms/tok" in lines[0]
    assert lines[1].startswith("sample tokens: [")
    V = get_arch(arch).smoke.vocab_size
    assert res["tokens"].shape == (2, 5) and res["logits"].shape == (2, V)
    assert torch.isfinite(res["logits"]).all()
    assert ((res["tokens"] >= 0) & (res["tokens"] < V)).all()
    assert res["prefill_ms"] > 0 and res["decode_ms_per_token"] > 0


def test_serve_and_model_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("llama3.2-1b").smoke
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "llama3.2-1b", "--smoke"])
    for call in (lambda: tt.init_params(cfg), lambda: tt.init_cache(cfg, 1, 8),
                 lambda: params_from_jax({}, cfg)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


@pytest.mark.parametrize("arch,why", [
    ("hubert-xlarge", "encoder-only"),
    ("qwen2-vl-2b", "takes embeddings"),
])
def test_serve_refuses_unported_families(arch, why):
    with pytest.raises(SystemExit, match=why):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
