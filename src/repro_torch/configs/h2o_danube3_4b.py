"""h2o-danube-3-4b [arXiv:2401.16818 family]: 24L d=3840 32H GQA(kv=8)
hd=120, d_ff=10240, vocab 32000, sliding-window attention (llama+mistral
mix). SWA makes it long_500k-eligible with a windowed KV cache."""
from .base import ArchSpec, ModelConfig, register

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, head_dim=120, d_ff=10240, vocab_size=32000,
    sliding_window=4096, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="h2o-danube-3-4b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=8, n_kv_heads=2, head_dim=8, d_ff=160, vocab_size=128,
    sliding_window=32,
)

register("h2o-danube-3-4b", ArchSpec(CONFIG, SMOKE,
                                     microbatch_overrides={"train_4k": 8}))
