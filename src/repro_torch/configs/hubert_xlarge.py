"""hubert-xlarge [arXiv:2106.07447]: encoder-only, 48L d=1280 16H MHA hd=80,
d_ff=5120, 504 cluster targets. The conv waveform frontend is a stub per the
assignment: input_specs() provides precomputed frame embeddings (B, S, d).
Encoder-only => no decode shapes (documented skip)."""
from .base import ArchSpec, ModelConfig, register

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, head_dim=80, d_ff=5120, vocab_size=504,
    causal=False, embed_input=False,
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=32,
    causal=False, embed_input=False,
)

register("hubert-xlarge", ArchSpec(CONFIG, SMOKE,
                                   microbatch_overrides={"train_4k": 4}))
