"""The decoder/encoder LM on PyTorch: the port of
``repro/models/transformer.py`` for every family of the zoo — dense,
MoE (kimi, moonshot), SSM (mamba2), hybrid (jamba), VLM with M-RoPE
(qwen2-vl) and the audio encoder (hubert).

Parameters are plain dicts of tensors: ``embed`` (absent where the model
takes embeddings, ``embed_input=False``), ``layers`` (one dict per layer,
the ``first_dense`` prefix layers first, then the groups of
``group_pattern`` in layer order: ``norm1``, ``attn`` or ``mamba``, and
unless the kind is ``mamba_only``, ``norm2`` and ``mlp`` or ``moe``),
``final_norm`` and, unless the embeddings are tied, ``head``. The
reference stacks the layers for a ``lax.scan``, a JAX compile matter: the
port runs its layers in a Python loop. Where a gradient is recorded and
``cfg.remat`` is set (the default), each layer runs under
``torch.utils.checkpoint`` and is recomputed in the backward pass, as the
reference's ``jax.checkpoint`` recomputes each scanned group; PyTorch has
no ``dots`` save policy, so every ``remat_policy`` recomputes the whole
layer, which gives the same values (ROADMAP.md §3). The serving steps run
under ``torch.inference_mode()`` (``train/serve_step.py``). The cache is
``{"layers": [...]}``, one entry a layer: an attention layer's ``{"k",
"v", "slot_pos"}`` ring buffer of ``min(max_len, sliding_window)`` slots,
written in place, or a mamba layer's ``{"conv", "ssm"}`` states, which a
prefill or a decode step replaces, in the reference's types.

``shard_fns`` (``sharding_plan.make_shard_fns``) apply the reference's
``hidden`` constraint to the residual stream after the embedding and each
layer. With parameters placed on a mesh (DTensors, ``sharding_plan``) and
a batch of DTensors, ``apply_model`` runs each layer's mesh version: the
embedding (a vocabulary split over the model axis gives each rank its
rows, the partial lookups summed), the layers, and the head (logits split
over the vocabulary like the embedding), returned as a DTensor; aux is
then this data rank's share. ``init_cache`` with ``shard_fns`` makes a
cache of DTensors in ``cache_pspecs``'s placements, each rank allocating
only its block.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers, mamba2

Params = Dict[str, Any]


def group_pattern(cfg) -> List[str]:
    if cfg.family == "ssm":
        return ["mamba_only"]
    size = cfg.attn_period if cfg.is_hybrid else 1
    start = cfg.first_dense
    return [cfg.layer_kind(start + i) for i in range(size)]


def n_groups(cfg) -> int:
    size = len(group_pattern(cfg))
    return (cfg.n_layers - cfg.first_dense) // size


def layer_kinds(cfg) -> List[str]:
    """The kind of each entry of ``params["layers"]``: the prefix's
    ``attn`` layers, then ``group_pattern`` once a group."""
    return ["attn"] * cfg.first_dense + group_pattern(cfg) * n_groups(cfg)


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


def _init_mlp(gen, cfg, dtype, ff: int):
    D = cfg.d_model
    s = 1.0 / math.sqrt(D)
    return {"w_gate": _normal(gen, (D, ff), s, dtype),
            "w_up": _normal(gen, (D, ff), s, dtype),
            "w_down": _normal(gen, (ff, D), 1.0 / math.sqrt(ff), dtype)}


def _init_moe(gen, cfg, dtype):
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.d_ff
    s = 1.0 / math.sqrt(D)
    return {"router": _normal(gen, (D, E), s, dtype),
            "w_gate": _normal(gen, (E, D, F_), s, dtype),
            "w_up": _normal(gen, (E, D, F_), s, dtype),
            "w_down": _normal(gen, (E, F_, D), 1.0 / math.sqrt(F_), dtype)}


def _init_block(gen, kind: str, cfg, dtype, dense_ff: Optional[int] = None):
    D = cfg.d_model
    zeros = lambda: torch.zeros((D,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    p: Params = {"norm1": zeros()}
    if kind.startswith("attn"):
        p["attn"] = _init_attn(gen, cfg, dtype)
    else:
        p["mamba"] = mamba2.init_mamba2_params(gen, cfg, dtype)
    if kind == "mamba_only":
        return p
    p["norm2"] = zeros()
    if kind.endswith("_moe"):
        p["moe"] = _init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = _init_mlp(gen, cfg, dtype,
                             dense_ff or cfg.d_ff_dense or cfg.d_ff)
    return p


def init_params(cfg, seed: int = 0, *, device="cuda",
                dtype=torch.float32) -> Params:
    """f32 master weights with the reference's shapes and scales, drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed``. The same
    seed gives other weights than JAX's ``init_params`` (ROADMAP.md §3);
    ``convert.params_from_jax`` carries the reference's weights over."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, V = cfg.d_model, cfg.vocab_size
    p: Params = {}
    if cfg.embed_input:
        p["embed"] = _normal(gen, (V, D), 0.02, dtype)
    p["layers"] = [_init_block(gen, kind, cfg, dtype)
                   for kind in layer_kinds(cfg)]
    p["final_norm"] = torch.zeros((D,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        p["head"] = _normal(gen, (D, V), 0.02, dtype)
    return p


# ------------------------------------------------------------------ cache

def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", shard_fns=None) -> Params:
    if shard_fns is not None and getattr(shard_fns, "mesh", None) is not None:
        return _init_cache_dist(cfg, batch_size, max_len, dtype, device,
                                shard_fns)
    dev = resolve_device(device)
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len

    def attn_cache():
        return {"k": torch.zeros((batch_size, W, KH, hd), dtype=dtype,
                                 device=dev),
                "v": torch.zeros((batch_size, W, KH, hd), dtype=dtype,
                                 device=dev),
                "slot_pos": torch.full((batch_size, W), -1,
                                       dtype=torch.int32, device=dev)}

    def mamba_cache():
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        return {"conv": torch.zeros((batch_size, cfg.d_conv - 1, conv_dim),
                                    dtype=dtype, device=dev),
                "ssm": torch.zeros((batch_size, cfg.ssm_heads,
                                    cfg.ssm_head_dim, cfg.ssm_state),
                                   dtype=torch.float32, device=dev)}

    return {"layers": [attn_cache() if kind.startswith("attn")
                       else mamba_cache() for kind in layer_kinds(cfg)]}


def _init_cache_dist(cfg, batch_size, max_len, dtype, device, sf):
    """``init_cache``'s cache as DTensors of ``cache_pspecs``'s placements,
    each rank making only its local block."""
    from torch.distributed.tensor import DTensor
    from . import sharding_plan as sp
    meta = init_cache(cfg, batch_size, max_len, dtype, "meta")
    specs = sp.cache_pspecs(cfg, meta, batch_size, sf.mesh)
    dev = sf.mesh.device
    coord = [sf.mesh.coords()[a] for a in sf.mesh.axis_names]

    def make(t, spec):
        pl = sp.placements(sf.mesh, spec, t.ndim)
        shape, _ = sp.local_box(t.shape, sf.mesh.shape, coord, pl)
        fill = -1 if t.dtype == torch.int32 else 0
        loc = torch.full(tuple(shape), fill, dtype=t.dtype, device=dev)
        return DTensor.from_local(loc, sf.dmesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return sp._zip_specs(make, meta, specs)


# ------------------------------------------------------------------ apply

def _block_apply(kind: str, p: Params, h, positions, cfg, shard_fns, cache,
                 pos3):
    """One layer. With a cache, one token decodes and a longer input is a
    prefill that builds the layer's cache (the reference's
    ``make_cache``); returns (h, new_cache or None, aux)."""
    aux = None
    x = layers.rms_norm(h, p["norm1"], cfg.rms_eps)
    if kind.startswith("attn"):
        y, nc = layers.attention_block(p["attn"], x, positions, cfg,
                                       shard_fns, cache=cache, pos3=pos3)
    elif cache is not None and h.shape[1] > 1:
        y, nc = mamba2_prefill(p["mamba"], x, cfg, shard_fns)
    else:
        y, nc = mamba2.mamba2_block(p["mamba"], x, cfg, shard_fns,
                                    cache=cache)
    h = h + y
    if kind == "mamba_only":
        return h, nc, aux
    x = layers.rms_norm(h, p["norm2"], cfg.rms_eps)
    if kind.endswith("_moe"):
        y, aux = layers.moe_block(p["moe"], x, cfg, shard_fns)
    else:
        y = layers.mlp_block(p["mlp"], x, cfg.mlp, shard_fns)
    return h + y, nc, aux


def mamba2_prefill(p, x_normed, cfg, shard_fns=None):
    """Prefill for SSM blocks: full SSD + final state as cache. The conv
    state is the last K-1 conv inputs (zeros before a prompt shorter than
    that) in the compute type, the SSM state f32, whatever ``init_cache``
    made, as in the reference."""
    if layers._dist(x_normed):
        return mamba2.mamba2_dist(p, x_normed, cfg, shard_fns, prefill=True)
    B, S, D = x_normed.shape
    dt_ = x_normed.dtype
    z, conv_in, dt_raw = mamba2._in_proj(p, x_normed, cfg)
    K = cfg.d_conv
    pad = max(0, (K - 1) - S)
    conv_state = F.pad(conv_in, (0, 0, pad, 0))[:, -(K - 1):]
    conv_out, _ = mamba2._conv1d_causal(conv_in, p["conv_w"].to(dt_))
    xh, Bm, Cm, dt, A = mamba2._ssm_inputs(p, conv_out, dt_raw, cfg, dt_)
    xh = layers.shard(shard_fns, "ssm_x", xh)
    y, h_last = mamba2.ssd_chunked(xh, dt, A, Bm.float(), Cm.float())
    out = mamba2._out_proj(p, y, xh, z, cfg, dt_)
    return out, {"conv": conv_state, "ssm": h_last}


def _records_grad(h, p) -> bool:
    """Whether autograd records the layer: grad mode on and its input or
    one of its weights needs a gradient."""
    if not torch.is_grad_enabled():
        return False
    if h.requires_grad:
        return True
    stack = [p]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, torch.Tensor) and x.requires_grad:
            return True
    return False


def apply_model(params: Params, cfg, batch: Dict[str, Any], *,
                shard_fns=None, cache: Optional[Params] = None,
                logits_mode: str = "all", compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (logits, new_cache, aux_loss); aux_loss is the MoE layers'
    Switch losses summed (0 without MoE).

    batch: tokens (B, S) integers, or embeds (B, S, D) where the model
    takes embeddings; optional positions (B, S) and pos3 (3, B, S). cache
    => prefill (S > 1) or decode (S == 1); attention caches are updated in
    place, mamba caches replaced. Without a cache the call is
    differentiable; with ``cfg.remat`` each layer whose work autograd
    records is checkpointed.
    """
    if layers._dist(params["final_norm"]):
        return _apply_dist(params, cfg, batch, shard_fns, cache, logits_mode,
                           compute_dtype)
    if cfg.embed_input:
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = F.embedding(tokens.long(), params["embed"]).to(compute_dtype)
    else:
        h = batch["embeds"].to(compute_dtype)
        B, S = h.shape[:2]
    h = _scale_embeds(h, cfg, compute_dtype)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device).expand(B, S)
    pos3 = batch.get("pos3")
    h, new_cache, aux_total = _layers(params, cfg, h, positions, pos3,
                                      shard_fns, cache)
    h = layers.rms_norm(h, params["final_norm"], cfg.rms_eps)
    head = params.get("head")
    if head is None:
        head = params["embed"].T
    return _logits(h, head, logits_mode), new_cache, aux_total


def _scale_embeds(h, cfg, compute_dtype):
    """h · sqrt(d_model), the factor rounded to the compute type, where
    the config scales its embeddings."""
    if not cfg.scale_embeds:
        return h
    return h * torch.sqrt(torch.tensor(float(cfg.d_model),
                                       dtype=torch.float32)
                          ).to(compute_dtype).to(h.device)


def _logits(h, head, logits_mode: str):
    """f32 logits of every position, or of the last (B, V)."""
    if logits_mode == "last":
        h = h[:, -1:, :]
    logits = (h @ head.to(h.dtype)).float()
    return logits[:, 0, :] if logits_mode == "last" else logits


def _layers(params, cfg, h, positions, pos3, shard_fns, cache):
    """The layers in order, each checkpointed where ``cfg.remat`` asks and
    autograd records it; -> (h, new cache or None, aux summed)."""
    h = layers.shard(shard_fns, "hidden", h)
    aux_total = torch.zeros((), dtype=torch.float32, device=positions.device)
    new_layers = []
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        sub_cache = cache["layers"][i] if cache is not None else None
        if cfg.remat and cache is None and _records_grad(h, p):
            h, nc, aux = checkpoint(_block_apply, kind, p, h, positions, cfg,
                                    shard_fns, None, pos3,
                                    use_reentrant=False)
        else:
            h, nc, aux = _block_apply(kind, p, h, positions, cfg, shard_fns,
                                      sub_cache, pos3)
        h = layers.shard(shard_fns, "hidden", h)
        new_layers.append(nc)
        if aux is not None:
            aux_total = aux_total + aux
    return h, ({"layers": new_layers} if cache is not None else None), \
        aux_total


def _local(x):
    from .sharding_plan import _is_dtensor
    return x.to_local() if _is_dtensor(x) else x


def _apply_dist(params, cfg, batch, sf, cache, logits_mode, compute_dtype):
    """``apply_model`` on a mesh (module doc). The logits are a DTensor
    (B, S, V), split over the model axis on V where the head's vocabulary
    is."""
    from . import sharding_plan as sp
    M, r = sp.model_size(sf), sp.model_rank(sf)
    Pt, Rp = sp.partial(), sp.replicate()
    emb, vs_emb = None, False
    if cfg.embed_input:
        tok = _local(batch["tokens"]).long()
        B_l, S = tok.shape
        vs_emb = sp.model_sharded(params["embed"]) and M > 1
        emb = sp.weight(sf, params["embed"], keep_model=True,
                        model_grad=Rp, dtype=compute_dtype)
        if vs_emb:
            V_l = emb.shape[0]
            t = tok - r * V_l
            ok = (t >= 0) & (t < V_l)
            h_l = F.embedding(t.clamp(0, V_l - 1), emb) * ok[..., None]
        else:
            h_l = F.embedding(tok, emb)
        h_l = _scale_embeds(h_l.to(compute_dtype), cfg, compute_dtype)
        h = sp.join(sf, h_l, sp.act(sf, Pt if vs_emb else Rp))
    else:
        h = _scale_embeds(batch["embeds"].to(compute_dtype), cfg,
                          compute_dtype)
        B_l, S = h.to_local().shape[:2]
    positions = batch.get("positions")
    positions = torch.arange(S, dtype=torch.int32, device=sf.mesh.device
                             ).expand(B_l, S) if positions is None \
        else _local(positions)
    pos3 = batch.get("pos3")
    pos3 = None if pos3 is None else _local(pos3)
    h, new_cache, aux_total = _layers(params, cfg, h, positions, pos3, sf,
                                      cache)
    h = layers.rms_norm(h, params["final_norm"], cfg.rms_eps)
    if "head" in params:
        vs = sp.model_sharded(params["head"]) and M > 1
        hw = sp.weight(sf, params["head"], keep_model=True, model_grad=Rp,
                       dtype=compute_dtype)
    else:
        vs, hw = vs_emb, emb.T
    logits = _logits(sp.local(h, sp.act(sf, Pt if vs else Rp)), hw,
                     logits_mode)
    logits = sp.wrap(sf, logits, sp.act(sf, sp.shard_dim(logits.ndim - 1)
                                         if vs else Rp))
    return logits, new_cache, aux_total
