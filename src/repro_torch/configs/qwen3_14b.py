"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B family; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    vocab=151936,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
