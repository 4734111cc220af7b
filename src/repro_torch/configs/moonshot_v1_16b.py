"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d=2048 16H
MHA(kv=16) hd=128, MoE 64e top-6 d_ff=1408/expert, vocab 163840."""
from .base import ArchSpec, ModelConfig, register

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=163840,
    n_experts=64, experts_per_token=6, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32, vocab_size=128,
    n_experts=8, experts_per_token=2,
)

register("moonshot-v1-16b-a3b",
         ArchSpec(CONFIG, SMOKE, microbatch_overrides={"train_4k": 16}))
