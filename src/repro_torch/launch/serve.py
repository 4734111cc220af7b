"""LM serving launcher on PyTorch: batched prefill + decode loop with KV/SSM
caches; the port of ``repro.launch.serve``.

This is the *language-model* serving path (one-shot benchmark of the
``train.serve_step`` prefill/decode step factories), not the MSA
service.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch h2o-danube-3-4b [--smoke] [--batch 4 --prompt-len 32 --gen 16] \
      [--device cuda|cpu]

Flags:
  --arch          architecture name (repro_torch.configs registry)
  --batch         concurrent decode sequences
  --prompt-len    prefill length (tokens)
  --gen           tokens to generate per sequence
  --smoke         use the reduced smoke config (CPU-friendly)
  --device        the card (``cuda``, the default; raises without one) or
                  the plain PyTorch path (``cpu``)

The weights are random f32 master weights from a ``torch.Generator``
seeded 0 (``models.transformer.init_params``), the prompt random tokens
from one seeded 1. Prints the reference's two lines. Every family that
decodes from tokens is served: dense, MoE, SSM and hybrid. An
encoder-only architecture (hubert-xlarge) exits as in the reference. A
model that takes embeddings (qwen2-vl-2b) exits too: this launcher makes
tokens only, and the reference's dies on it with a ``KeyError``
(ROADMAP.md §3); the serving steps take its embeddings
(``train.serve_step``).
"""
from __future__ import annotations

import argparse
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="LM serving benchmark: batched prefill + decode with "
                    "KV/SSM caches (PyTorch/CUDA port)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="run on the card (default; raises without one) "
                         "or on the plain PyTorch path on the CPU")
    return ap


@torch.inference_mode()
def main(argv=None):
    """Run the benchmark; returns a dict with the generated ``tokens``
    (B, gen), the last ``logits`` (B, V) and ``prefill_ms`` /
    ``decode_ms_per_token`` (host clock around work that ends in a device
    sync)."""
    args = build_parser().parse_args(argv)

    from ..configs import get_arch

    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only; no decode")
    if not cfg.embed_input:
        raise SystemExit(f"{args.arch} takes embeddings (embed_input=False), "
                         "which this launcher does not make; drive it "
                         "through train.serve_step with batch['embeds']")

    from ..device import resolve_device, sync
    from ..models.transformer import init_params
    from ..train.serve_step import make_decode_step, make_prefill_step

    dev = resolve_device(args.device)
    params = init_params(cfg, 0, device=dev)
    max_len = args.prompt_len + args.gen
    prefill = make_prefill_step(cfg, max_len=max_len)
    decode = make_decode_step(cfg)

    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=gen, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": toks})
    sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [torch.argmax(logits, -1).to(torch.int32)]
    pos = torch.full((args.batch,), args.prompt_len, dtype=torch.int32,
                     device=dev)
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, cache = decode(params, cache, out[-1], pos)
        out.append(torch.argmax(logits, -1).to(torch.int32))
        pos = pos + 1
    sync(dev)
    t_decode = time.perf_counter() - t0
    tokens = torch.stack(out, 1)
    decode_ms = t_decode / max(args.gen - 1, 1) * 1e3
    print(f"prefill {args.batch}x{args.prompt_len}: {t_prefill * 1e3:.1f} "
          f"ms; decode {args.gen - 1} steps: {decode_ms:.1f} ms/tok")
    print("sample tokens:", tokens[0][:10].tolist())
    return {"tokens": tokens, "logits": logits,
            "prefill_ms": t_prefill * 1e3, "decode_ms_per_token": decode_ms}


if __name__ == "__main__":
    main()
