"""The LM (ROADMAP.md §1 item 14): the dense attention family on PyTorch.
``layers`` (norms, RoPE, attention through the flash-attention kernel,
gated MLPs), ``transformer`` (init, cache, apply), ``convert`` (parameters
from the JAX package's pytree)."""
