"""The port's sharded path on the card (``gpu``; skipped where no CUDA device
is visible): a world of one NCCL rank (a ``FileStore`` under ``tmp_path``)
and its (1, 1) host mesh; reduced models' prefill laid out by the planner
and run under its hints through the hand-written kernels on the local
shards, bit for bit with the unsharded kernel route, their launches
counted.  No JAX import: a card test runs where only PyTorch is installed."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed import make_plan, param_shardings
from repro_torch.distributed.context import sharding_context
from repro_torch.distributed.sharding import distribute_batch, distribute_tree
from repro_torch.kernels import KERNELS
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.models import forward_prefill, init_params

pytestmark = [pytest.mark.torch, pytest.mark.gpu]

SSD = ("ssd_gram", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")


@pytest.fixture
def nccl_mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL and the model's kernels run only there)")
    init_distributed(init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,over,dtype,kernel,per_call", [
    ("tinyllama_1_1b", {"n_layers": 3, "head_dim": 64}, torch.bfloat16,
     ("flash_attention_wgmma",), 3),
    ("mamba2_2_7b", {"n_layers": 3}, torch.float32, SSD, 3),
], ids=["tinyllama", "mamba2"])
def test_sharded_prefill_on_card_matches_unsharded(nccl_mesh, arch, over, dtype, kernel, per_call):
    cfg = get_config(arch).reduced(**over)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), dtype, "cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (1, 256))).cuda()}
    plan = make_plan(cfg, nccl_mesh)
    dparams = distribute_tree(params, param_shardings(plan, params))
    with torch.no_grad():
        want = forward_prefill(cfg, params, batch)
        before = {n: KERNELS[n].launches for n in kernel}
        with sharding_context(nccl_mesh, plan):
            got = forward_prefill(cfg, dparams, distribute_batch(plan, batch))
        torch.cuda.synchronize()
    assert {n: KERNELS[n].launches - before[n] for n in kernel} == dict.fromkeys(kernel, per_call)
    assert torch.equal(got.full_tensor(), want)
