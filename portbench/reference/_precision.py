"""Precision switches shared by the references."""

from contextlib import contextmanager

import torch


@contextmanager
def no_tf32():
    """Float32 products in float32: cuBLAS and cuDNN may otherwise round
    their operands to TF32 on this card."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), the rounding a tensor core applies to float32 operands; works on
    any device, so the control reads the same on the CPU."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
