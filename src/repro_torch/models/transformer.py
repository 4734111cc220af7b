"""The decoder LM on PyTorch: the port of ``repro/models/transformer.py``
for the dense attention family (gemma-2b, qwen1.5-0.5b, llama3.2-1b,
h2o-danube-3-4b).

Parameters are plain dicts of tensors: ``embed``, ``layers`` (one dict per
layer: ``norm1``, ``attn``, ``norm2``, ``mlp``), ``final_norm`` and, unless
the embeddings are tied, ``head``. The reference stacks the layers for a
``lax.scan`` and rematerializes them; both are JAX compile matters, so the
port runs its layers in a Python loop under ``torch.inference_mode()``.
The cache is ``{"layers": [{"k", "v", "slot_pos"}, ...]}``, a bf16 ring
buffer of ``min(max_len, sliding_window)`` slots per layer, written in
place.

The MoE, SSM, hybrid, VLM (M-RoPE) and audio families are not ported:
their configs resolve, and every function here raises naming ROADMAP.md
§1 item 14.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import layers

Params = Dict[str, Any]

PORTED_FAMILIES = ("dense",)


def check_ported(cfg) -> None:
    """Raise for a family this port does not run yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            "(ROADMAP.md §1 item 14: MoE, Mamba2/SSD, hybrid, M-RoPE/VLM "
            "and the audio encoder)")


def group_pattern(cfg) -> List[str]:
    if cfg.family == "ssm":
        return ["mamba_only"]
    size = cfg.attn_period if cfg.is_hybrid else 1
    start = cfg.first_dense
    return [cfg.layer_kind(start + i) for i in range(size)]


def n_groups(cfg) -> int:
    size = len(group_pattern(cfg))
    return (cfg.n_layers - cfg.first_dense) // size


# ------------------------------------------------------------------- init

def _normal(gen, shape, std, dtype):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype) * std


def _init_attn(gen, cfg, dtype):
    D, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(D)
    p = {"wq": _normal(gen, (D, H * hd), s, dtype),
         "wk": _normal(gen, (D, KH * hd), s, dtype),
         "wv": _normal(gen, (D, KH * hd), s, dtype),
         "wo": _normal(gen, (H * hd, D), 1.0 / math.sqrt(H * hd), dtype)}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KH * hd), ("bv", KH * hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p


def _init_mlp(gen, cfg, dtype):
    D, ff = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(D)
    return {"w_gate": _normal(gen, (D, ff), s, dtype),
            "w_up": _normal(gen, (D, ff), s, dtype),
            "w_down": _normal(gen, (ff, D), 1.0 / math.sqrt(ff), dtype)}


def init_params(cfg, seed: int = 0, *, device="cuda",
                dtype=torch.float32) -> Params:
    """f32 master weights with the reference's shapes and scales, drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed``. The same
    seed gives other weights than JAX's ``init_params`` (ROADMAP.md §3);
    ``convert.params_from_jax`` carries the reference's weights over."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, V = cfg.d_model, cfg.vocab_size
    zeros = lambda: torch.zeros((D,), dtype=dtype, device=dev)  # noqa: E731
    p: Params = {"embed": _normal(gen, (V, D), 0.02, dtype), "layers": []}
    for _ in range(cfg.n_layers):
        p["layers"].append({"norm1": zeros(),
                            "attn": _init_attn(gen, cfg, dtype),
                            "norm2": zeros(),
                            "mlp": _init_mlp(gen, cfg, dtype)})
    p["final_norm"] = zeros()
    if not cfg.tie_embeddings:
        p["head"] = _normal(gen, (D, V), 0.02, dtype)
    return p


# ------------------------------------------------------------------ cache

def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> Params:
    check_ported(cfg)
    dev = resolve_device(device)
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return {"layers": [
        {"k": torch.zeros((batch_size, W, KH, hd), dtype=dtype, device=dev),
         "v": torch.zeros((batch_size, W, KH, hd), dtype=dtype, device=dev),
         "slot_pos": torch.full((batch_size, W), -1, dtype=torch.int32,
                                device=dev)}
        for _ in range(cfg.n_layers)]}


# ------------------------------------------------------------------ apply

def _block_apply(p: Params, h, positions, cfg, cache):
    x = layers.rms_norm(h, p["norm1"], cfg.rms_eps)
    y, nc = layers.attention_block(p["attn"], x, positions, cfg, cache=cache)
    h = h + y
    x = layers.rms_norm(h, p["norm2"], cfg.rms_eps)
    return h + layers.mlp_block(p["mlp"], x, cfg.mlp), nc


@torch.inference_mode()
def apply_model(params: Params, cfg, batch: Dict[str, Any], *,
                cache: Optional[Params] = None, logits_mode: str = "all",
                compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (logits, new_cache, aux_loss); aux_loss is 0 (no MoE).

    batch: tokens (B, S) integers, optional positions (B, S). cache =>
    prefill (S > 1) or decode (S == 1); the cache is updated in place.
    """
    check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = F.embedding(tokens.long(), params["embed"]).to(compute_dtype)
    if cfg.scale_embeds:
        h = h * torch.sqrt(torch.tensor(float(cfg.d_model),
                                        dtype=torch.float32)
                           ).to(compute_dtype).to(h.device)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device).expand(B, S)
    new_layers = []
    for i, p in enumerate(params["layers"]):
        sub_cache = cache["layers"][i] if cache is not None else None
        h, nc = _block_apply(p, h, positions, cfg, sub_cache)
        new_layers.append(nc)
    new_cache = {"layers": new_layers} if cache is not None else None

    h = layers.rms_norm(h, params["final_norm"], cfg.rms_eps)
    if logits_mode == "last":
        h = h[:, -1:, :]
    head = params.get("head")
    if head is None:
        head = params["embed"].T
    logits = (h @ head.to(h.dtype)).float()
    if logits_mode == "last":
        logits = logits[:, 0, :]
    return logits, new_cache, torch.zeros((), device=h.device)
