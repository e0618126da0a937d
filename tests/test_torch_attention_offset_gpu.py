"""Both CUDA attention kernels at a query offset, on the card (``gpu``;
skipped where no CUDA device is visible): a rank's query rows [o, o + n)
of a causal self-attention over the whole sequence's keys, at
``q_offset=o`` (``models.layers.on_local_heads`` under a ``context``
plan), through ``ops.attention_op``.  Each call launches its route's one
kernel, and its output is held against the plain version at the offset
and against the same rows of the kernel's whole-sequence call, at the
tolerances of ``test_torch_kernels.py``'s card test.  No JAX import: a
card test runs where only PyTorch is installed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import KERNELS, ops
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import flash_attention_plain

pytestmark = [pytest.mark.torch, pytest.mark.gpu]

BF16, F32 = torch.bfloat16, torch.float32
# (batch x heads, S, rows, offset, D, dtype): the tensor cores at D 64, 128
# (an offset off the 128-row tile, rows filling half a tile) and 256, and
# the first rank (offset 0, Sq < Skv); the SIMT kernel in f32 (an offset
# off its 64-row tile) and in bf16 at a head dim that is not a multiple of 8
CASES = [
    (2, 256, 64, 192, 64, BF16),
    (2, 256, 128, 128, 128, BF16),
    (2, 192, 64, 100, 128, BF16),
    (1, 256, 64, 192, 256, BF16),
    (2, 256, 64, 0, 64, BF16),
    (2, 256, 64, 37, 64, F32),
    (1, 200, 40, 160, 100, BF16),
]


@pytest.mark.parametrize("bh,s,n,off,d,dtype", CASES, ids=[
    f"{bh}x{n}at{o}of{s}x{d}-{str(t)[6:]}" for bh, s, n, o, d, t in CASES])
def test_cuda_attention_at_an_offset_matches_plain_version_on_card(bh, s, n, off, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    rng = np.random.default_rng(bh * s + n + off + d)
    q, k, v = (ops.to_tensor(rng.standard_normal((bh, s, d)).astype(np.float32), dtype)
               for _ in range(3))
    rows = q[:, off : off + n].contiguous()
    kw = dict(causal=True, block_q=8, block_kv=8)
    name = "flash_attention_wgmma" if fa_mod._route(rows) == "wgmma" else "flash_attention"
    assert (name == "flash_attention_wgmma") == (dtype == BF16 and d % 8 == 0)
    before = {key: launcher.launches for key, launcher in KERNELS.items()}
    got = ops.attention_op(rows, k, v, q_offset=off, **kw)
    torch.cuda.synchronize()
    assert {key: launcher.launches - before[key] for key, launcher in KERNELS.items()
            if launcher.launches != before[key]} == {name: 1}
    whole = ops.attention_op(q, k, v, **kw)[:, off : off + n]
    want = flash_attention_plain(rows, k, v, q_offset=off, **kw)
    assert got.shape == (bh, n, d) and got.dtype == dtype
    tol = 2e-3 if dtype == F32 else 3e-2
    for other in (want, whole):
        torch.testing.assert_close(got.float(), other.float(), rtol=tol, atol=tol)
