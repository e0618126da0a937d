"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT frontend (stubbed: patch embeddings provided by
``input_specs``) + mistral-nemo-style decoder. [hf:mistralai/Pixtral-12B-2409;
unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    vocab=131072,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    frontend="vision_patches",
)
