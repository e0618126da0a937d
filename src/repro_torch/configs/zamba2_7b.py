"""zamba2-7b [hybrid]: 81L d_model=3584 Mamba2 blocks + one *shared*
attention block (32H kv=32, d_ff=14336) applied every 6 blocks,
vocab=32000, ssm_state=64. [arXiv:2411.15242; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    vocab=32000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    ssm_state=64,
    ssm_heads=112,            # d_inner / ssm_head_dim = 7168 / 64
    ssm_head_dim=64,
    d_inner=7168,
    shared_attn_every=6,
    subquadratic=True,        # SSM-dominant
)
