"""ConvNeXt's block (Liu et al., arXiv:2201.03545) on the port's normal path:
depthwise 7x7, LayerNorm, a 4x GELU MLP, layer scale and the residual.

The block needs two unary ops in the value language (``sqrt`` for
LayerNorm's scale, ``erf`` for the exact GELU), LayerNorm's per-pixel
reductions over the channels, and a plan shape of its own: the MLP chains
two reductions through its hidden axis, 4x the channels, too wide for one
block's shared memory at ConvNeXt-T's stage-3 widths (14 x 14 x 384, hidden
1536), so the planner walks the hidden axis in panels inside one group
(``plan.HiddenChain``): the hidden tensor is never a group's output.  The
plain route is held against the benchmark's plain reference
(``portbench/reference/convnext.py``) at tiny sizes, the chained plan at the
published widths against the verifier, and the compile counters.
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.apps import make_app
from repro_torch.backend import compile_pipeline
from repro_torch.backend.cuda_codegen import (
    chain_tile, emit_library, hidden_tile, shared_bytes, smem_layout, staged_inputs)
from repro_torch.backend.eager import LoweredGroup
from repro_torch.backend.errors import PlanError
from repro_torch.backend.plan import HiddenChain, build_pipeline_plan
from repro_torch.backend.verify import assert_plan_verified, verify_plan
from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK
from repro_torch.frontend import Func, Var, count_ops, erf, execute_pipeline, expr_depth
from repro_torch.frontend import lower_pipeline, sqrt

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = dict(img=14, dim=384, hidden=1536)
CPU = dict(device="cpu", kernels="eager")


def _reference():
    sys.path.insert(0, str(ROOT))
    try:
        from portbench.reference import convnext
    finally:
        sys.path.remove(str(ROOT))
    return convnext


def _inputs(img, dim, hidden, batch, seed):
    """Seeded weights drawn as the benchmark's configuration draws them
    (He-normal depthwise and linear weights, LayerNorm's affine near (1, 0),
    small biases, a layer scale of order 1), shared by the slots."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, std=1.0):
        return torch.randn(shape, generator=g) * std

    ws = {"dw_weights": n(7, 7, dim, std=(2 / 49) ** 0.5), "dw_bias": n(dim, std=0.02),
          "ln_weight": 1 + n(dim, std=0.05), "ln_bias": n(dim, std=0.05),
          "w1": n(hidden, dim, std=(2 / dim) ** 0.5), "b1": n(hidden, std=0.02),
          "w2": n(dim, hidden, std=(2 / hidden) ** 0.5), "b2": n(dim, std=0.02),
          "layer_scale": 0.5 + torch.rand(dim, generator=g)}
    ins = {n_: t.expand(batch, *t.shape).contiguous() for n_, t in ws.items()}
    ins["ifmap"] = n(batch, img + 6, img + 6, dim)
    return ins


def _plan(kw, **ckw):
    app = make_app("convnext", **kw)
    return build_pipeline_plan(app.pipeline, **{"vmem_budget": H100_SMEM_PER_BLOCK, **ckw})


# (app kwargs, plan kwargs): the Pallas model fuses the tiny block into one
# group; a budget too small for it chains the hidden axis (twelve panels of
# 2 on a padded row grid, 5 = 2 x 4 - 3)
TINY = [({"img": 4, "dim": 8, "hidden": 32}, {}),
        ({"img": 5, "dim": 8, "hidden": 24}, {"vmem_budget": 2200})]


@pytest.mark.parametrize("kw,ckw", TINY, ids=["fused", "chained"])
def test_tiny_block_holds_against_the_benchmark_reference(kw, ckw):
    """The plain route against ``F.conv2d``, ``F.layer_norm``, ``F.linear``
    and ``F.gelu`` (TF32 off): the same f32 operations in other orders
    (LayerNorm's moments, the linears' sums) move the widest output by a few
    units in its last place, far under 1e-5; the TF32 control, which rounds
    the convolution's and the linears' operands to 10 bits, lands above."""
    app = make_app("convnext", **kw)
    pp = compile_pipeline(app.pipeline, batch=2, batch_capacity=2, **ckw, **CPU)
    (k,) = pp.kernels
    assert (k.kg.chain is not None) == bool(ckw)
    ins = _inputs(kw["img"], kw["dim"], kw["hidden"], 2, sum(kw.values()))
    got = pp.run(ins)["convnext"]
    ref = _reference().reference
    want = ref(ins)["convnext"]
    assert got.shape == want.shape == (2, kw["img"], kw["img"], kw["dim"])
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) < 1e-5
    assert float((ref(ins, "tf32")["convnext"] - want).abs().max() / scale) > 1e-5


def test_unary_ops_in_the_reference_interpreter_and_the_plain_route():
    """``sqrt`` and ``erf`` evaluate, count and nest as one op each; the
    reference interpreter (double precision) and the plain route (torch's
    f32 ops) agree with torch's own."""
    x = Var("x")
    inp = Func.input("input", 1)
    f = Func("f")
    f[x] = sqrt(inp[x] * inp[x] + 1) + erf(inp[x] * 0.5)
    f.hw_accelerate()
    assert count_ops(f.expr) == 6 and expr_depth(f.expr) == 4
    pipe = lower_pipeline(f, [inp, f], {"x": 9})
    a = np.linspace(-3, 3, 9).astype(np.float32)
    got = execute_pipeline(pipe, {"input": a})["f"]
    t = torch.from_numpy(a).double()
    want = torch.sqrt(t * t + 1) + torch.erf(t * 0.5)
    assert max(abs(got[(i,)] - float(want[i])) for i in range(9)) < 1e-12
    pp = compile_pipeline(pipe, **CPU)
    assert float((pp({"input": a}) - want.float()).abs().max()) < 1e-6
    # a square root of a negative number is NaN, as IEEE's
    g = Func("g")
    g[x] = sqrt(inp[x])
    gp = lower_pipeline(g, [inp, g], {"x": 2})
    out = execute_pipeline(gp, {"input": np.array([-1.0, 4.0], np.float32)})["g"]
    assert math.isnan(out[(0,)]) and out[(1,)] == 2.0


def test_published_widths_plan_one_chained_group():
    """At the published widths and batch 32 the whole block plans as one
    group that the verifier certifies: the 1536-wide hidden tensor (fc1 and
    its GELU) is never a group's output, a block of two rows holds 32 of its
    1536 channels at a time (48 panels), each of 448 threads two positions
    of one channel (their fc1 chains side by side, each LayerNorm row and w1
    word loaded once for both), fc2's sums in the depthwise panel's words
    (no stage reads it once LayerNorm is done), the weights indexed along
    the hidden axis (w1, b1, w2) staged a panel at a time, those read only
    before the chain (the depthwise's and LayerNorm's) not at all, and
    nothing spills."""
    plan = _plan(PUBLISHED, batch=32, batch_capacity=32)
    assert_plan_verified(plan)
    (kg,) = plan.kernels
    assert kg.stage_names == ["dw_conv", "ln_sum", "ln_mean", "ln_var_sum", "ln_rstd", "ln",
                              "fc1", "gelu", "fc2", "convnext"]
    assert all(1536 not in k.output.nstage.pure_extents for k in plan.kernels)
    ch = kg.chain
    assert (ch.hidden, ch.consumer, ch.extent, ch.block, ch.count, ch.tile) == (
        ("fc1", "gelu"), "fc2", 1536, 32, 48, (2, 1))
    assert ch.reuse == (("fc2", "dw_conv"),)
    assert plan.spill_bytes() == 0 and kg.panels is None
    assert (kg.bh, kg.grid) == (2, (32, 7))
    assert ch.unstaged == ("dw_bias", "dw_weights", "ln_bias", "ln_weight")
    lg = LoweredGroup(kg)
    staged = {st.buffer: st.panel for st in staged_inputs(lg)}
    assert staged == {"w1": (0, 32), "b1": (0, 32), "w2": (1, 32), "layer_scale": None,
                      "b2": None}
    # the plan counts what the kernel allocates, once: 93,632 B of scratch
    # (fc2's 43,008 in the depthwise panel's words) and 103,552 B of copies
    bpr, fixed = kg.ws
    assert shared_bytes(lg) == kg.vmem_bytes == bpr * kg.bh + fixed == 197184
    assert shared_bytes(lg) <= H100_SMEM_PER_BLOCK
    offs, _r, scratch = smem_layout(kg)
    names = [sp.name for sp, _k in lg.entries]
    assert offs[names.index("fc2")] == offs[names.index("dw_conv")] == 0
    assert scratch == 93632 and fixed == 103552 == sum(st.smem_bytes for st in staged_inputs(lg))
    ct = chain_tile(lg)
    assert ct.groups * ct.lanes == 512
    assert ct.groups * ct.rows >= ct.outer == 28 and ct.lanes * ct.cols >= ct.inner == 384
    assert ct.rows * ct.cols <= 32
    # the hidden panel in one pass: 14 groups of 32 lanes, two positions each
    ht = hidden_tile(lg)
    assert (ht.lanes, ht.cols, ht.groups, ht.rows, ht.outer, ht.inner) == (32, 1, 14, 2, 28, 32)
    src = emit_library([lg])
    assert src.count("__global__") == 1 and "kc < 48" in src and "erff(" in src
    assert "w < 448; w += 512" in src and "const float4 q1_1 =" in src


def test_split_into_groups_the_hidden_tensor_spills():
    """Without fusion every stage is a group of its own and the hidden
    tensor makes round trips through HBM: the chain is what keeps it on
    chip."""
    plan = _plan(PUBLISHED, fuse=False)
    assert plan.kernels[-1].chain is None
    assert any(1536 in k.output.nstage.pure_extents for k in plan.kernels)
    assert plan.spill_bytes() > 2 * 4 * 14 * 14 * 1536


def _tampered(plan, **changes):
    (kg,) = plan.kernels
    kg.chain = dataclasses.replace(kg.chain, **changes)
    return plan


def test_verifier_refuses_broken_chains():
    # a panel that does not divide the hidden extent
    rules = {v.rule for v in verify_plan(_tampered(_plan(PUBLISHED), block=24 + 1))}
    assert "UB405" in rules
    # the whole hidden axis at once: the working set drifts from the plan
    # and no longer fits the budget
    rules = {v.rule for v in verify_plan(_tampered(_plan(PUBLISHED), block=1536))}
    assert {"UB402", "UB403"} <= rules
    # a weight staged along an axis the chain does not index by the hidden one
    plan = _plan(PUBLISHED)
    staged = tuple((gi, 1 - a) if len(plan.kernels[0].groups[gi].span) == 2 else (gi, a)
                   for gi, a in plan.kernels[0].chain.staged)
    assert "UB405" in {v.rule for v in verify_plan(_tampered(plan, staged=staged))}
    # a stage outside the chain declared hidden
    plan = _plan(PUBLISHED)
    assert "UB405" in {v.rule for v in verify_plan(_tampered(plan, hidden=("ln", "fc1", "gelu")))}
    # a panel that takes the words of one the chain still reads (fc1 reads
    # LayerNorm's panel through every hidden panel, while GELU writes), or
    # of one too small to hold it
    plan = _plan(PUBLISHED)
    assert_plan_verified(plan)
    rules = {v.rule for v in verify_plan(_tampered(plan, reuse=(("gelu", "ln"),)))}
    assert "UB405" in rules
    plan = _plan(PUBLISHED)
    rules = {v.rule for v in verify_plan(_tampered(plan, reuse=(("ln", "ln_sum"),)))}
    assert "UB405" in rules
    # a chain declared on a group that carries rows
    plan = build_pipeline_plan(make_app("gaussian", size=30).pipeline, block_h=4)
    (kg,) = plan.kernels
    kg.chain = HiddenChain(("gaussian",), "gaussian", 28, 4, ())
    assert "UB405" in {v.rule for v in verify_plan(plan)}
    with pytest.raises(PlanError):
        assert_plan_verified(plan)


COUNTERS = ("compile.chain_groups", "compile.chain_tiled_groups", "compile.chain_panels")


def _delta(before):
    after = telemetry.counters()
    return tuple(after.get(k, 0.0) - before.get(k, 0.0) for k in COUNTERS)


def test_compile_counts_its_chained_groups_and_panels():
    """A compile that misses the cache adds its chained groups to
    ``compile.chain_groups``, those whose hidden panel takes a register
    tile of two or more elements a thread to ``compile.chain_tiled_groups``,
    and the hidden panels a block of them walks to ``compile.chain_panels``;
    a hit adds nothing, and a plan without a chain adds 0."""
    kw, ckw = TINY[1]
    app = make_app("convnext", **kw)
    before = telemetry.counters()
    pp = compile_pipeline(app.pipeline, cache=True, **ckw, **CPU)
    assert pp.kernels[0].kg.chain.tile == (2, 1)
    assert _delta(before) == (1.0, 1.0, float(pp.kernels[0].kg.chain.count)) == (1.0, 1.0, 12.0)
    before = telemetry.counters()
    compile_pipeline(app.pipeline, cache=True, **ckw, **CPU)          # a hit
    assert _delta(before) == (0.0, 0.0, 0.0)
    before = telemetry.counters()
    compile_pipeline(make_app("convnext", **TINY[0][0]).pipeline, cache=False, **CPU)
    assert _delta(before) == (0.0, 0.0, 0.0)


# the benchmark's other configurations at their cells' sizes and batches,
# each with its group's shared-memory layout (scratch offsets, ring
# offsets, bytes) as the chain's panel reuse leaves it: untouched
CELL_PLANS = [
    ("harris", {"schedule": "sch3", "size": 2048}, 8,
     ([0, 258, 516, 1806, 3086, 3344, 3602, 4892, 6172], [7452, 7712, 7972, 8232, 8492], 39168)),
    ("resnet", {"img": 56, "cin": 64, "cout": 64}, 8, ([], [], 0)),
    ("mobilenet", {"img": 14, "cin": 512, "cout": 512}, 32, ([0], [], 28672)),
]


@pytest.mark.parametrize("name,kw,batch,layout", CELL_PLANS, ids=[c[0] for c in CELL_PLANS])
def test_plans_without_a_chain_count_no_tiled_chain(name, kw, batch, layout):
    """harris, resnet and mobilenet plan no chain at their cells' sizes: they
    add 0 to every chain counter, and their shared memory is laid out as
    before the chain's panels could take dead panels' words."""
    before = telemetry.counters()
    pp = compile_pipeline(make_app(name, **kw).pipeline, batch=batch, batch_capacity=batch,
                          cache=False, **CPU)
    assert _delta(before) == (0.0, 0.0, 0.0)
    (kg,) = pp.plan.kernels
    assert kg.chain is None and smem_layout(kg) == layout


def test_make_app_names_the_known_apps():
    with pytest.raises(ValueError, match="no app 'convnxt'.*'convnext'.*'mobilenet'"):
        make_app("convnxt")


@pytest.mark.gpu
def test_published_widths_block_on_card():
    """The published-width block at batch 32 on the card: one launch of the
    chained group (panels of 32, two positions of one hidden channel a
    thread), bit for bit with the plain version of the same plan (both call
    the device library's ``erff``) and within 1e-5 of the benchmark's plain
    reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    app = make_app("convnext", **PUBLISHED)
    pp = compile_pipeline(app.pipeline, batch=32, batch_capacity=32)
    (k,) = pp.kernels
    assert (k.kg.chain.block, k.kg.chain.tile) == (32, (2, 1))
    ins = {n: t.cuda() for n, t in _inputs(**PUBLISHED, batch=32, seed=38).items()}
    got = pp.run(ins)["convnext"]
    assert got.is_cuda and k.launches == 1
    assert torch.equal(got, k.plain(ins))
    want = _reference().reference(ins)["convnext"]
    scale = want.abs().flatten(1).amax(1)
    assert float(((got - want).abs().flatten(1).amax(1) / scale).max()) < 1e-5
