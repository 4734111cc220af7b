"""Serving steps on PyTorch: prefill (sequence -> last logits + cache) and
decode (one token per call against the cache); the port of
``repro/train/serve_step.py``, for models that take tokens or embeddings
(``embed_input=False``: ``batch["embeds"]`` and a (B, D) row a decode
step). The caches live on the parameters' device. The steps and
``greedy_generate`` run under ``torch.inference_mode()``: they record no
gradient. With ``shard_fns`` (``sharding_plan.make_shard_fns``),
parameters placed on its mesh and a batch of DTensors, the steps run on
the mesh and the cache is made in ``cache_pspecs``'s placements.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.transformer import apply_model, init_cache


def _device(params):
    return params["final_norm"].device


def make_prefill_step(cfg, *, shard_fns=None, max_len: Optional[int] = None):
    @torch.inference_mode()
    def prefill(params, batch):
        x = batch["tokens"] if cfg.embed_input else batch["embeds"]
        B, S = x.shape[:2]
        cache = init_cache(cfg, B, max_len or S, device=_device(params),
                           shard_fns=shard_fns)
        logits, cache, _ = apply_model(params, cfg, batch,
                                       shard_fns=shard_fns, cache=cache,
                                       logits_mode="last")
        return logits, cache
    return prefill


def _unsqueeze(x, dim: int, batch_dim: int = 0):
    """``x.unsqueeze(dim)``; a DTensor's on its local block (DTensor's view
    operations refuse inference tensors), its batch split kept."""
    from ..models.sharding_plan import _is_dtensor
    if not _is_dtensor(x):
        return x.unsqueeze(dim)
    from torch.distributed.tensor import DTensor, Shard
    pl = [Shard(batch_dim + (dim <= batch_dim)) if p.is_shard() else p
          for p in x.placements]
    shape = list(x.shape)
    shape.insert(dim, 1)
    loc = x.to_local().unsqueeze(dim)
    return DTensor.from_local(loc, x.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous(shape))


def _contiguous(shape):
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def make_decode_step(cfg, *, shard_fns=None):
    """decode(params, cache, tokens (B,) or embeds (B, D), pos (B,)) ->
    (logits (B, V), cache). An M-RoPE model's three position streams are
    ``pos`` each, as in the reference."""
    @torch.inference_mode()
    def decode(params, cache, token, pos):
        batch = {"tokens" if cfg.embed_input else "embeds":
                 _unsqueeze(token, 1), "positions": _unsqueeze(pos, 1)}
        if cfg.m_rope:
            p = _unsqueeze(pos, 1)
            from ..models.sharding_plan import _is_dtensor
            if _is_dtensor(p):
                p = p.to_local()
            batch["pos3"] = p[None].expand((3,) + tuple(p.shape))
        logits, cache, _ = apply_model(params, cfg, batch,
                                       shard_fns=shard_fns, cache=cache,
                                       logits_mode="last")
        return logits, cache
    return decode


@torch.inference_mode()
def greedy_generate(cfg, params, prompt_tokens, *, steps: int, max_len: int,
                    shard_fns=None):
    """Reference generation loop for the examples/tests (prefill + N
    decodes) -> (B, steps) int32 tokens."""
    prefill = make_prefill_step(cfg, shard_fns=shard_fns, max_len=max_len)
    decode = make_decode_step(cfg, shard_fns=shard_fns)
    B, S = prompt_tokens.shape
    logits, cache = prefill(params, {"tokens": prompt_tokens})
    out = [torch.argmax(logits, -1).to(torch.int32)]
    pos = torch.full((B,), S, dtype=torch.int32, device=logits.device)
    for _ in range(steps - 1):
        logits, cache = decode(params, cache, out[-1], pos)
        out.append(torch.argmax(logits, -1).to(torch.int32))
        pos = pos + 1
    return torch.stack(out, dim=1)
