"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens (frontend stubbed: frame
embeddings provided by ``input_specs``). [arXiv:2306.05284; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    vocab=2048,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    frontend="audio_frames",
)
