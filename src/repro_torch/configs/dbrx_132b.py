"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) expert d_ff=10752
vocab=100352, 16 experts top-4 fine-grained. [hf:databricks/dbrx-base;
unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    vocab=100352,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    n_experts=16,
    n_shared_experts=0,
    top_k=4,
    moe_d_ff=10752,
)
