"""qwen2-vl-2b [arXiv:2409.12191]: 28L d=1536 12H GQA(kv=2) hd=128,
d_ff=8960, vocab 151936, M-RoPE (t/h/w sections). The vision frontend is a
stub per the assignment: input_specs() provides precomputed patch embeddings
(B, S, d_model) + 3D position ids."""
from .base import ArchSpec, ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, head_dim=128, d_ff=8960, vocab_size=151936,
    m_rope=True, m_rope_sections=(16, 24, 24), embed_input=False,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=128,
    m_rope=True, m_rope_sections=(2, 3, 3), embed_input=False,
)

register("qwen2-vl-2b", ArchSpec(CONFIG, SMOKE,
                                 microbatch_overrides={"train_4k": 4}))
