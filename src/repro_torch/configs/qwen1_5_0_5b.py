"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: 24L d=1024 16H MHA(kv=16) hd=64,
d_ff=2816 SwiGLU, vocab 151936, QKV bias, tied embeddings."""
from .base import ArchSpec, ModelConfig, register

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=2816, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=96, vocab_size=128,
    qkv_bias=True, tie_embeddings=True,
)

register("qwen1.5-0.5b", ArchSpec(CONFIG, SMOKE,
                                  microbatch_overrides={"train_4k": 4}))
