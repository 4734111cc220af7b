"""mamba2-130m [arXiv:2405.21060]: 24L d=768 attention-free SSD,
ssm_state=128, expand=2 (d_inner 1536, 24 heads @ hd 64), vocab 50280."""
from .base import ArchSpec, ModelConfig, register

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, d_conv=4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab_size=128,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, d_conv=4,
    tie_embeddings=True,
)

register("mamba2-130m", ArchSpec(CONFIG, SMOKE,
                                 microbatch_overrides={"train_4k": 2}))
