"""mamba2-2.7b [ssm]: 64L d_model=2560 attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    vocab=50280,
    d_ff=0,
    ssm_state=128,
    ssm_heads=80,             # d_inner / ssm_head_dim = 5120 / 64
    ssm_head_dim=64,
    d_inner=5120,
    attention_free=True,
    subquadratic=True,
)
