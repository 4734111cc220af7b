"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B]: 16L d=2048 32H GQA(kv=8) hd=64,
d_ff=8192 SwiGLU, vocab 128256."""
from .base import ArchSpec, ModelConfig, register

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192, vocab_size=128256,
    rope_theta=500000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=8, n_kv_heads=2, head_dim=8, d_ff=192, vocab_size=128,
    tie_embeddings=True,
)

register("llama3.2-1b", ArchSpec(CONFIG, SMOKE,
                                 microbatch_overrides={"train_4k": 4}))
