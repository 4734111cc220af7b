"""kimi-k2-1t-a32b [arXiv:2501 / Kimi K2 paper-table]: 61L d=7168 64H
GQA(kv=8) hd=112, MoE 384e top-8 d_ff=2048/expert, first layer dense
(d_ff 18432), vocab 163840 — the trillion-parameter stress test."""
from .base import ArchSpec, ModelConfig, register

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, head_dim=112, d_ff=2048, vocab_size=163840,
    n_experts=384, experts_per_token=8, first_dense=1, d_ff_dense=18432,
    capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe", n_layers=3, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=128,
    n_experts=8, experts_per_token=2, first_dense=1, d_ff_dense=96,
)

register("kimi-k2-1t-a32b",
         ArchSpec(CONFIG, SMOKE, microbatch_overrides={"train_4k": 32,
                                                       "prefill_32k": 1}))
