"""Model configuration covering the ten assigned architecture families."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    vocab: int
    # attention (0s for attention-free families)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0     # 0 = full attention
    global_every: int = 0       # gemma3: 1 global layer per N (5 local : 1 global)
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    d_inner: int = 0
    conv_width: int = 4
    # hybrid (zamba2): one *shared* attention block applied every N blocks
    shared_attn_every: int = 0
    # modality frontend stub
    frontend: str = "none"      # none | vision_patches | audio_frames
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # which attention layers exist (ssm/hybrid use none/shared)
    attention_free: bool = False
    # sub-quadratic? (long_500k eligibility)
    subquadratic: bool = False

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        base = dict(
            n_layers=2,
            d_model=64,
            vocab=256,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            n_experts=4 if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            moe_d_ff=32 if self.moe_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            ssm_head_dim=8 if self.ssm_heads else 64,
            d_inner=32 if self.d_inner else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            global_every=self.global_every,
            name=self.name + "-smoke",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND roofline math)."""
        d = self.d_model
        n = self.vocab * d  # embeddings
        if not self.tie_embeddings:
            n += self.vocab * d
        per_layer = 0
        shared_block = self.shared_attn_every > 0
        if not self.attention_free and not shared_block:
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.d_ff and not shared_block:
            per_layer += 3 * d * self.d_ff
        if self.n_experts:
            per_layer += (self.n_experts + self.n_shared_experts) * 3 * d * self.moe_d_ff
            per_layer += d * self.n_experts  # router
        if self.d_inner:
            # in_proj (x, z, B, C, dt) + out_proj + conv
            proj = d * (2 * self.d_inner + 2 * self.ssm_state + self.ssm_heads)
            per_layer += proj + self.d_inner * d + self.conv_width * self.d_inner
        n += self.n_layers * per_layer
        if self.shared_attn_every:
            # one weight-shared attention+MLP block (Zamba2)
            n += d * self.q_dim * 2 + 2 * d * self.kv_dim + 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_routed = self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        active_routed = self.n_layers * self.top_k * 3 * d * self.moe_d_ff
        return full - all_routed + active_routed


__all__ = ["ModelConfig"]
