"""Assigned architecture configs (``--arch <id>``), copied from the JAX
package with the imports rewritten.

Each module defines ``CONFIG`` with the exact published hyperparameters.
"""

from importlib import import_module
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "qwen3_14b",
    "gemma3_1b",
    "glm4_9b",
    "tinyllama_1_1b",
    "qwen2_moe_a2_7b",
    "dbrx_132b",
    "pixtral_12b",
    "musicgen_medium",
    "zamba2_7b",
    "mamba2_2_7b",
]

# canonical dashed ids (CLI) -> module names
DASHED = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    mod = arch.replace("-", "_").replace(".", "_")
    if mod not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(DASHED)}")
    return import_module(f"repro_torch.configs.{mod}").CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "get_config", "all_configs"]
