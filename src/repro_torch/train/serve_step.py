"""Serving steps on PyTorch: prefill (sequence -> last logits + cache) and
decode (one token per call against the cache); the port of
``repro/train/serve_step.py``. The caches live on the parameters' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.transformer import apply_model, init_cache


def _device(params):
    return params["final_norm"].device


def make_prefill_step(cfg, *, max_len: Optional[int] = None):
    def prefill(params, batch):
        B, S = batch["tokens"].shape
        cache = init_cache(cfg, B, max_len or S, device=_device(params))
        logits, cache, _ = apply_model(params, cfg, batch, cache=cache,
                                       logits_mode="last")
        return logits, cache
    return prefill


def make_decode_step(cfg):
    """decode(params, cache, tokens (B,), pos (B,)) -> (logits (B, V),
    cache)."""
    def decode(params, cache, token, pos):
        batch = {"tokens": token[:, None], "positions": pos[:, None]}
        logits, cache, _ = apply_model(params, cfg, batch, cache=cache,
                                       logits_mode="last")
        return logits, cache
    return decode


def greedy_generate(cfg, params, prompt_tokens, *, steps: int, max_len: int):
    """Reference generation loop for the examples/tests (prefill + N
    decodes) -> (B, steps) int32 tokens."""
    prefill = make_prefill_step(cfg, max_len=max_len)
    decode = make_decode_step(cfg)
    B, S = prompt_tokens.shape
    logits, cache = prefill(params, {"tokens": prompt_tokens})
    out = [torch.argmax(logits, -1).to(torch.int32)]
    pos = torch.full((B,), S, dtype=torch.int32, device=logits.device)
    for _ in range(steps - 1):
        logits, cache = decode(params, cache, out[-1], pos)
        out.append(torch.argmax(logits, -1).to(torch.int32))
        pos = pos + 1
    return torch.stack(out, dim=1)
