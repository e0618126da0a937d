"""The hand-written Hopper kernels of the port, the counterpart of
``src/repro/kernels/``: ``stencil3x3``, ``matmul``, ``flash_attention`` and
``ssd_scan``, each CUDA C++ for ``sm_90a`` in ``csrc/`` beside a plain
PyTorch version, the torch oracles (``ref``) and the ``ops`` entry points.

``KERNELS`` maps each CUDA kernel's name to its launcher, which holds the
source path and the count of launches; ``ssd_scan`` is four kernels,
``ssd_gram``, ``ssd_chunk_state``, ``ssd_state_pass`` and
``ssd_chunk_out``, and ``matmul`` and ``flash_attention`` each
route bf16 calls that TMA can read to a tensor-core kernel
(``matmul_wgmma``, ``flash_attention_wgmma``) and every other call to a
SIMT kernel (``matmul``, ``flash_attention``); a SIMT matmul that splits K
adds its splits with a second kernel, ``matmul_reduce``.
"""

from . import flash_attention, matmul, ssd, stencil

KERNELS = {
    k.name: k
    for k in (
        stencil.KERNEL, matmul.KERNEL, matmul.REDUCE, matmul.WGMMA, flash_attention.KERNEL,
        flash_attention.WGMMA, ssd.GRAM, ssd.STATE, ssd.PASS, ssd.OUT,
    )
}

__all__ = ["KERNELS"]
