"""MobileNet v1's stride-1 depthwise-separable blocks at their published
widths (Howard et al., arXiv:1704.04861, Table 1), planned at batch 32
against the H100's shared memory per block.

From 56x56x128 on, the fused depthwise -> pointwise group does not fit the
Pallas working-set model (every view double-buffered in VMEM, the whole
pointwise weight resident), so the planner plans it against shared memory
as the CUDA kernel fills it (``plan.WeightPanels``): the depthwise panel is
the unified buffer and stays in shared memory, the pointwise weight is
staged in panels of the input channels its reduction runs over, and each
output's sum stays in registers across them.  Each block plans as one group that
the verifier certifies under its unchanged budget rule (UB402, 227 KiB)
and the emitter emits within that budget; the
112x112x32 block keeps its plan; the verifier refuses a panel plan that
breaks the mode's rules or the budget; and the plain route agrees with the
benchmark's plain reference at full channel widths.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.apps import make_app
from repro_torch.backend import compile_pipeline
from repro_torch.backend.cuda_codegen import (
    OutputTile, carries_nothing, emit_library, output_tile, shared_bytes, staged_inputs,
)
from repro_torch.backend.eager import LoweredGroup
from repro_torch.backend.errors import PlanError
from repro_torch.backend.plan import WeightPanels, build_pipeline_plan
from repro_torch.backend.verify import assert_plan_verified, verify_plan
from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
BATCH = dict(batch=32, batch_capacity=32)
# (img, cin, cout): the stride-1 blocks of Table 1 past the first, and the
# panel each stages (input channels of the pointwise weight)
BLOCKS = [
    ((56, 128, 128), 128),
    ((28, 256, 256), 128),
    ((14, 512, 512), 64),
    ((7, 1024, 1024), 32),
]


def _plan(img, cin, cout, **kw):
    app = make_app("mobilenet", img=img, cin=cin, cout=cout)
    return build_pipeline_plan(app.pipeline, vmem_budget=H100_SMEM_PER_BLOCK, **BATCH, **kw)


@pytest.mark.parametrize("block,panel", BLOCKS, ids=[f"{b[0]}x{b[1]}" for b, _ in BLOCKS])
def test_block_plans_verifies_and_emits_as_one_group(block, panel):
    plan = _plan(*block)
    (kg,) = plan.kernels
    assert kg.stage_names == ["dw_conv", "mobilenet"]
    assert_plan_verified(plan)
    assert plan.spill_bytes() == 0
    assert kg.panels == WeightPanels(group=4, axis=1, block=panel, extent=block[1])
    lg = LoweredGroup(kg)
    assert carries_nothing(lg)
    src = emit_library([lg])
    assert src.count("__global__") == 1 and f"kc < {kg.panels.count}" in src
    # the plan counts what the kernel allocates: the depthwise panel, the
    # depthwise weights whole and one panel of the pointwise weights
    staged = {st.buffer: st for st in staged_inputs(lg)}
    assert staged["dw_weights"].panel is None
    assert staged["pw_weights"].panel == (1, panel)
    assert staged["pw_weights"].extents == (block[2], panel)
    assert shared_bytes(lg) == kg.vmem_bytes <= H100_SMEM_PER_BLOCK
    bpr, fixed = kg.ws
    assert 2 * bpr * kg.bh + fixed <= H100_SMEM_PER_BLOCK
    # one pass: every accumulator of a thread's tile in registers
    ot = output_tile(lg)
    assert ot.groups * ot.rows >= ot.outer and ot.lanes * ot.cols >= ot.inner == block[2]
    assert ot.rows * ot.cols <= 32


@pytest.mark.parametrize("block,panel", BLOCKS[:1], ids=["56x128"])
def test_the_split_plan_spills_the_depthwise_output(block, panel):
    """Forced apart, the depthwise output makes a round trip through HBM."""
    plan = _plan(*block, fuse=False)
    assert [kg.name for kg in plan.kernels] == ["dw_conv", "mobilenet"]
    assert plan.spill_bytes() == 2 * 4 * 56 * 56 * 128 == 2 * 1605632


def test_first_block_keeps_its_plan():
    """The 112x112x32 -> 64 block fits the Pallas model and plans as before:
    one group, no panels, both weights staged whole, a 7 x 2 register tile
    (here at batch 32; at batch 8 the plan is the JAX planner's, which
    ``test_torch_plan_parity`` holds)."""
    plan = _plan(112, 32, 64)
    (kg,) = plan.kernels
    assert kg.panels is None and plan.spill_bytes() == 0
    assert (kg.bh, kg.grid, kg.ws, kg.vmem_bytes) == (1, (32, 112), (86784, 9344), 168576)
    lg = LoweredGroup(kg)
    assert [(st.buffer, st.extents, st.strides, st.panel) for st in staged_inputs(lg)] == [
        ("dw_weights", (32, 3, 3), (9, 3, 1), None), ("pw_weights", (64, 32), (33, 1), None)]
    assert output_tile(lg) == OutputTile(32, 2, 8, 7, 112, 64)
    assert "kc <" not in emit_library([lg])


def _tampered(plan, **changes):
    (kg,) = plan.kernels
    kg.panels = dataclasses.replace(kg.panels, **changes)
    return plan


def test_verifier_refuses_broken_panel_plans():
    # a panel that does not divide the input channels
    rules = {v.rule for v in verify_plan(_tampered(_plan(14, 512, 512), block=48))}
    assert "UB404" in rules
    # the whole weight at once: the staged bytes drift from the planned
    # working set, which no longer fits the budget
    rules = {v.rule for v in verify_plan(_tampered(_plan(14, 512, 512), block=512))}
    assert {"UB402", "UB403"} <= rules
    # panels along an axis the reduction does not index
    rules = {v.rule for v in verify_plan(_tampered(_plan(14, 512, 512), axis=0))}
    assert "UB404" in rules
    # panels declared on a group that carries rows
    plan = build_pipeline_plan(make_app("gaussian", size=30).pipeline, block_h=4)
    (kg,) = plan.kernels
    assert kg.rings
    kg.panels = WeightPanels(group=0, axis=0, block=1, extent=28)
    assert "UB404" in {v.rule for v in verify_plan(plan)}
    with pytest.raises(PlanError):
        assert_plan_verified(plan)


def _reference():
    sys.path.insert(0, str(ROOT))
    try:
        from portbench.reference import mobilenet
    finally:
        sys.path.remove(str(ROOT))
    return mobilenet.reference


@pytest.mark.parametrize("img,cin,cout", [(4, 512, 512), (4, 1024, 1024)])
def test_plain_route_holds_against_the_benchmark_reference(img, cin, cout):
    """The port's plain route (the panel plan at full channels) against
    ``portbench/reference/mobilenet.py`` (two ``F.conv2d`` calls, TF32 off).
    Both sum the same f32 products, in other orders: 512 or 1024 terms of
    mixed sign move the widest output by a few units in its last place
    (2^-24 ~ 6e-8 relative each), far below 1e-5, which a TF32 operand
    (2^-11 ~ 5e-4) would break."""
    app = make_app("mobilenet", img=img, cin=cin, cout=cout)
    pp = compile_pipeline(app.pipeline, device="cpu", kernels="eager", batch=2, batch_capacity=2)
    (k,) = pp.kernels
    assert k.kg.panels is not None
    g = torch.Generator().manual_seed(cin)
    ins = {
        "ifmap": torch.rand((2, img + 2, img + 2, cin), generator=g),
        "dw_weights": (torch.randn((cin, 3, 3), generator=g) * (2 / 9) ** 0.5).expand(2, -1, -1, -1),
        "pw_weights": (torch.randn((cout, cin), generator=g) * (2 / cin) ** 0.5).expand(2, -1, -1),
    }
    ins = {n: t.contiguous() for n, t in ins.items()}
    got = pp.run(ins)["mobilenet"]
    want = _reference()(ins)["mobilenet"]
    assert got.shape == want.shape == (2, img, img, cout)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
