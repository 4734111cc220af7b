"""gemma-2b [arXiv:2403.08295]: 18L d=2048 8H MQA(kv=1) head_dim=256,
GeGLU d_ff=16384, vocab 256000, tied embeddings, embedding scaling."""
from .base import ArchSpec, ModelConfig, register

CONFIG = ModelConfig(
    name="gemma-2b", family="dense", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384, vocab_size=256000,
    mlp="geglu", tie_embeddings=True, scale_embeds=True, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="gemma-2b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=128,
    mlp="geglu", tie_embeddings=True, scale_embeds=True,
)

register("gemma-2b", ArchSpec(CONFIG, SMOKE,
                              microbatch_overrides={"train_4k": 8}))
