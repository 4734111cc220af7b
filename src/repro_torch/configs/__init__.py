"""Assigned-architecture registry (the port's copy of ``repro.configs``).
Import side-effects register each arch."""
from . import (gemma_2b, qwen1_5_0_5b, llama3_2_1b, h2o_danube3_4b,  # noqa: F401
               jamba_1_5_large, mamba2_130m, kimi_k2, moonshot_v1_16b,  # noqa: F401
               qwen2_vl_2b, hubert_xlarge)  # noqa: F401
from .base import (ArchSpec, ModelConfig, ShapeSpec, SHAPES, get_arch,  # noqa: F401
                   shape_applicable)

ALL_ARCHS = [
    "gemma-2b", "qwen1.5-0.5b", "llama3.2-1b", "h2o-danube-3-4b",
    "jamba-1.5-large-398b", "mamba2-130m", "kimi-k2-1t-a32b",
    "moonshot-v1-16b-a3b", "qwen2-vl-2b", "hubert-xlarge",
]
