"""Serving steps on PyTorch: prefill (sequence -> last logits + cache) and
decode (one token per call against the cache); the port of
``repro/train/serve_step.py``, for models that take tokens or embeddings
(``embed_input=False``: ``batch["embeds"]`` and a (B, D) row a decode
step). The caches live on the parameters' device. The steps and
``greedy_generate`` run under ``torch.inference_mode()``: they record no
gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.transformer import apply_model, init_cache


def _device(params):
    return params["final_norm"].device


def make_prefill_step(cfg, *, max_len: Optional[int] = None):
    @torch.inference_mode()
    def prefill(params, batch):
        x = batch["tokens"] if cfg.embed_input else batch["embeds"]
        B, S = x.shape[:2]
        cache = init_cache(cfg, B, max_len or S, device=_device(params))
        logits, cache, _ = apply_model(params, cfg, batch, cache=cache,
                                       logits_mode="last")
        return logits, cache
    return prefill


def make_decode_step(cfg):
    """decode(params, cache, tokens (B,) or embeds (B, D), pos (B,)) ->
    (logits (B, V), cache). An M-RoPE model's three position streams are
    ``pos`` each, as in the reference."""
    @torch.inference_mode()
    def decode(params, cache, token, pos):
        if cfg.embed_input:
            batch = {"tokens": token[:, None], "positions": pos[:, None]}
        else:
            batch = {"embeds": token[:, None, :], "positions": pos[:, None]}
        if cfg.m_rope:
            batch["pos3"] = pos[None, :, None].expand((3,) + pos.shape
                                                      + (1,))
        logits, cache, _ = apply_model(params, cfg, batch, cache=cache,
                                       logits_mode="last")
        return logits, cache
    return decode


@torch.inference_mode()
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
