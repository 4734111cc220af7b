"""jamba-1.5-large-398b [arXiv:2403.19887]: 72L d=8192, Mamba:attention 7:1
interleave (1 attn per 8-layer group), 64H GQA(kv=8) hd=128, MoE 16e top-2
every other layer, d_ff=24576/expert, vocab 65536, ssm_state=128."""
from .base import ArchSpec, ModelConfig, register

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=24576, vocab_size=65536,
    n_experts=16, experts_per_token=2, moe_period=2, attn_period=8,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, d_conv=4,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=128,
    n_experts=4, experts_per_token=2, moe_period=2, attn_period=4,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, d_conv=4,
)

register("jamba-1.5-large-398b",
         ArchSpec(CONFIG, SMOKE, microbatch_overrides={"train_4k": 16}))
