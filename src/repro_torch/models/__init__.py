"""The LM on PyTorch, every family of the zoo (dense, MoE, SSM, hybrid,
VLM with M-RoPE, the audio encoder): ``layers`` (norms, RoPE / M-RoPE,
attention through the flash-attention kernel, gated MLPs, the MoE
block), ``mamba2`` (the SSD mixer), ``transformer`` (init, cache, apply),
``convert`` (parameters and caches from the JAX package's pytrees)."""
