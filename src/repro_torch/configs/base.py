"""Config schema shared by every architecture + the shape/arch registries.

One frozen dataclass covers the whole zoo (dense / MoE / SSM / hybrid / VLM /
audio); family-specific fields are zero/empty when unused. Every assigned
architecture file under repro_torch/configs instantiates exactly one
ModelConfig plus its reduced smoke-test variant.

The port's own copy of ``repro/configs`` (pure data, field for field), so
that ``get_arch`` resolves every name without the JAX package. ``remat``
checkpoints each layer of a training pass (``models/transformer.py``);
``remat_policy`` and ``unroll_layers`` are kept for the schema's sake:
they steer JAX's compiler and nothing in the port reads them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- features
    mlp: str = "swiglu"              # swiglu | geglu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    m_rope: bool = False             # 3-section multimodal RoPE (qwen2-vl)
    m_rope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w halves
    sliding_window: int = 0          # >0 => SWA
    causal: bool = True              # False => encoder-only
    embed_input: bool = True         # False => input is precomputed embeddings
    tie_embeddings: bool = False
    scale_embeds: bool = False       # gemma: x *= sqrt(d_model)
    rms_eps: float = 1e-6
    # --- MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1              # MoE every k-th layer (jamba: 2)
    first_dense: int = 0             # leading dense layers (kimi: 1)
    d_ff_dense: int = 0              # dense-layer FF width when mixed (kimi)
    capacity_factor: float = 1.25
    # --- SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    d_conv: int = 4
    attn_period: int = 0             # hybrid: 1 attention layer per group of k
    # --- training defaults
    remat: bool = True
    remat_policy: str = "dots"       # nothing | dots (save matmul outputs;
                                     # §Perf iter 5: -15% flops, same memory)
    # roofline mode: unroll the layer scan so XLA cost_analysis (which counts
    # while bodies ONCE) sees every layer's flops/bytes/collectives
    unroll_layers: bool = False

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM/hybrid/sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decode(self) -> bool:
        return self.causal

    def param_count(self) -> int:
        """Analytic parameter count (drives 6ND roofline numbers)."""
        D, V = self.d_model, self.vocab_size
        emb = V * D if self.embed_input else 0
        head = 0 if self.tie_embeddings else D * V
        per_attn = D * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * D
        gate_mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        def mlp_p(ff): return gate_mult * D * ff
        per_moe = self.n_experts * mlp_p(self.d_ff) + D * self.n_experts
        total = emb + head + 2 * D  # final norm + small extras
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            total += 2 * D  # norms
            if kind in ("attn", "attn_moe"):
                total += per_attn
            if kind in ("mamba", "mamba_moe"):
                di, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
                total += D * (2 * di + 2 * st + nh) + self.d_conv * (di + 2 * st) \
                    + 3 * nh + di + di * D
            if kind.endswith("_moe") or kind == "moe":
                total += per_moe
            elif kind in ("attn", "mamba", "dense"):
                ff = self.d_ff_dense or self.d_ff
                total += mlp_p(ff)
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top-k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        gate_mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if "moe" in self.layer_kind(i))
        moe_all = n_moe_layers * self.n_experts * gate_mult * self.d_model * self.d_ff
        moe_active = n_moe_layers * self.experts_per_token * gate_mult \
            * self.d_model * self.d_ff
        return full - moe_all + moe_active

    def layer_kind(self, i: int) -> str:
        """Kind of layer i: attn | mamba | moe-variants | dense FF pairing."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            pos = i % self.attn_period if self.attn_period else 1
            mixer = "attn" if pos == self.attn_period - 1 else "mamba"
            moe = (self.n_experts > 0 and i % self.moe_period == self.moe_period - 1)
            return f"{mixer}_moe" if moe else mixer
        if self.n_experts > 0:
            if i < self.first_dense:
                return "attn"
            return "attn_moe"
        return "attn"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1     # gradient-accumulation steps (train only)


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Skip rules from the assignment (documented in DESIGN.md)."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic"
    return True, ""


_REGISTRY: Dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    smoke: ModelConfig            # reduced same-family config for CPU tests
    microbatch_overrides: Dict[str, int] = dataclasses.field(default_factory=dict)


def register(arch_id: str, spec: ArchSpec):
    _REGISTRY[arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        # import side-effect registration
        from . import ALL_ARCHS  # noqa: F401
    return _REGISTRY[arch_id]


def list_archs():
    from . import ALL_ARCHS
    return list(ALL_ARCHS)
