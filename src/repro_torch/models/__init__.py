"""The port's model package: the ten architectures' configurations
(``ModelConfig``), train forward, prefill and decode over the JAX package's
parameter tree, with attention and the SSD scan on the hand-written
kernels (see ``model``)."""

from .config import ModelConfig
from .model import (
    LM,
    decode_step,
    forward_prefill,
    forward_train,
    init_kv_cache,
    init_params,
    params_from_jax,
)

__all__ = [
    "LM",
    "ModelConfig",
    "init_params",
    "forward_train",
    "forward_prefill",
    "decode_step",
    "init_kv_cache",
    "params_from_jax",
]
