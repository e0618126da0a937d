"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    vocab=151936,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
)
