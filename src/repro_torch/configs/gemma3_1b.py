"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    vocab=262144,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    sliding_window=1024,
    global_every=6,           # 5 local : 1 global
    rope_theta=1_000_000.0,
    subquadratic=True,        # sliding-window dominant
)
