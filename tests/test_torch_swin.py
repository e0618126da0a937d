"""Swin Transformer's block pair (Liu et al., arXiv:2103.14030) on the port's
normal path: a block over regular windows (W-MSA), then one over windows
shifted by half a window (SW-MSA), each window attention with a relative
position bias and a GELU MLP, both with LayerNorm and residuals.

The pair needs ``exp`` and a running maximum (a reduction's second
combiner) in the value language, for the softmax in its stable form; the
roll of the shifted block, a reduction of one-hot terms, since the index
language is affine; and a plan shape of its own: a window's score tile, a
head a block, held in shared memory beside the row statistics
(``plan.WindowAttention``, rule UB406), no score or probability ever a
group's output.  The plain route and the reference interpreter are held
against the benchmark's plain reference (``portbench/reference/swin.py``)
at tiny sizes, the plan at the published widths against the verifier, and
the compile counters.
"""

import dataclasses
import itertools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.apps import make_app
from repro_torch.backend import compile_pipeline
from repro_torch.backend.cuda_codegen import block_threads, emit_library, shared_bytes
from repro_torch.backend.eager import LoweredGroup
from repro_torch.backend.plan import WindowAttention, build_pipeline_plan, window_shape
from repro_torch.backend.verify import assert_plan_verified, verify_plan
from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK
from repro_torch.frontend import (
    Const, Func, RDom, Var, count_ops, eval_expr, execute_pipeline, exp,
    expr_depth, lower_pipeline, maximum)

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = dict(img=14, dim=384, heads=12, window=7, hidden=1536, shift=3)
CPU = dict(device="cpu", kernels="eager")
# a budget that plans the tiny pair as the published one plans: a window
# group and a chained MLP in each block
SMEM_TINY = 5000


def _reference():
    sys.path.insert(0, str(ROOT))
    try:
        from portbench.reference import swin
    finally:
        sys.path.remove(str(ROOT))
    return swin


def _inputs(app, batch, seed, qkv_scale=1.0):
    """Seeded weights drawn as the benchmark's configuration draws them
    (He-normal linears, LayerNorm's affine near (1, 0), small biases, a
    relative position bias of std 1), shared by the slots; ``qkv_scale``
    scales the qkv weights (and so the scores)."""
    g = torch.Generator().manual_seed(seed)
    ins = {}
    for name, shape in app.input_extents.items():
        if name == "ifmap":
            ins[name] = torch.randn((batch, *shape), generator=g)
            continue
        t = torch.randn(shape, generator=g)
        if name.endswith(("_weight",)):
            t = 1 + 0.05 * t
        elif name.endswith(("_bias", "_b")) and not name.endswith("rel_bias"):
            t = 0.02 * t
        elif name.endswith("_w"):
            fan_in = shape[1] if name.endswith("fc2_w") else app.input_extents["ifmap"][-1]
            t = t * (2 / fan_in) ** 0.5 * (qkv_scale if name.endswith("qkv_w") else 1.0)
        ins[name] = t.expand(batch, *shape).contiguous()
    return ins


def _plan(kw, **ckw):
    return build_pipeline_plan(make_app("swin", **kw).pipeline,
                               **{"vmem_budget": H100_SMEM_PER_BLOCK, **ckw})


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


# (app kwargs, plan kwargs): the tiny pair, the Pallas model holding its
# attention and MLP; the same under a budget that plans each block's window
# group and chain as the published widths do; a 6 x 6 map of 3 x 3 windows
# shifted by 1, three heads, so that each block holds several windows and
# the shifted ones wrap around the map
TINY = [({}, {}), ({}, {"vmem_budget": SMEM_TINY}),
        ({"img": 6, "dim": 12, "heads": 3, "window": 3, "hidden": 24, "shift": 1}, {})]


@pytest.mark.parametrize("kw,ckw", TINY, ids=["fused", "tiled", "three-windows"])
def test_tiny_pair_holds_against_the_benchmark_reference(kw, ckw):
    """The plain route against Swin's modules as the benchmark's reference
    writes them (``F.layer_norm``, ``torch.roll``, window partition, the
    bias gathered by the relative position index, the mask at -100,
    ``F.softmax``, ``F.linear``, ``F.gelu``; TF32 off): the same f32
    operations in other orders (LayerNorm's moments, the linears' and the
    products' sums, softmax's sum) move the widest output by a few units in
    its last place, far under 1e-5; the TF32 control, which rounds every
    product's operands to 10 bits, lands above."""
    app = make_app("swin", **kw)
    pp = compile_pipeline(app.pipeline, batch=2, batch_capacity=2, **ckw, **CPU)
    windows = [k.kg.window for k in pp.kernels if k.kg.window is not None]
    assert len(windows) == (2 if ckw else 0)
    ins = _inputs(app, 2, 39 + len(kw))
    got = pp.run(ins)["swin"]
    ref = _reference().reference
    want = ref(ins)["swin"]
    assert got.shape == want.shape == (2, *app.input_extents["ifmap"])
    assert _gap(got, want) < 1e-5
    assert _gap(ref(ins, "tf32")["swin"], want) > 1e-5


def test_tiny_pair_through_the_reference_interpreter():
    """The reference interpreter (pointwise, in double precision) against
    the plain reference in f32: a few f32 roundings of outputs of order 10,
    under 1e-5 of the widest."""
    app = make_app("swin")
    ins = _inputs(app, 1, 7)
    vals = execute_pipeline(app.pipeline, {n: t[0].numpy() for n, t in ins.items()})
    box = app.pipeline.buffer_boxes["swin"]
    got = np.zeros(box.extents)
    for idx, v in vals["swin"].items():
        got[idx] = v
    want = _reference().reference(ins)["swin"][0].numpy()
    assert float(np.abs(got - want).max() / np.abs(want).max()) < 1e-5


def test_exp_and_the_max_combiner():
    """``exp`` is one op, an ``exp`` past f32's range inf; a reduction
    written ``maximum(f[...], term)`` is a running maximum, in the
    reference interpreter and on the plain route, NaN-propagating as
    torch's ``maximum``; other update forms are refused."""
    x, y = Var("x"), Var("y")
    inp = Func.input("input", 2)
    r = RDom(5, name="r")
    m = Func("m")
    m[y] = Const(-math.inf)
    m.update((y,), maximum(m[y], inp[r[0], y]), r)
    m.store_root()
    s = Func("soft")
    s[x, y] = exp(inp[x, y] - m[y])
    s.hw_accelerate()
    assert m.reduction.combiner == "max" and count_ops(s.expr) == 2
    assert expr_depth(s.expr) == 2
    pipe = lower_pipeline(s, [inp, m, s], {"x": 5, "y": 3})
    a = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    a[1, 2] = 120.0
    want = np.exp(a - a.max(axis=1, keepdims=True))
    vals = execute_pipeline(pipe, {"input": a})
    got = np.array([[vals["soft"][(j, i)] for i in range(5)] for j in range(3)])
    assert np.allclose(got, want, rtol=1e-6) and got[1, 2] == 1.0
    assert [vals["m"][(j,)] for j in range(3)] == [float(v) for v in a.max(axis=1)]
    pp = compile_pipeline(pipe, **CPU)
    assert torch.allclose(pp.run({"input": a})["soft"], torch.from_numpy(want), rtol=1e-6)
    a[2, 4] = np.nan                          # the row's maximum is NaN
    soft = pp.run({"input": a})["soft"]
    assert torch.isnan(soft[2]).all() and torch.isfinite(soft[:2]).all()
    assert eval_expr(exp(Const(1000.0)), {}, None) == math.inf
    bad = Func("bad")
    bad[y] = 0
    with pytest.raises(ValueError, match="maximum"):
        bad.update((y,), bad[y] - inp[r[0], y], r)


def test_scores_above_88_stay_finite():
    """With the qkv weights scaled up 12x the scores exceed 88 (where
    ``exp`` of an unshifted score would overflow f32 and softmax turn into
    inf / inf): the stable form subtracts each row's maximum first, so the
    output is finite and matches torch's softmax."""
    import torch.nn.functional as F

    app = make_app("swin")
    ins = _inputs(app, 2, 11, qkv_scale=12.0)
    ref = _reference()
    # the first block's scores of the first image, as Swin's module forms them
    x = ins["ifmap"][0].reshape(4, 4, 16)
    t = F.layer_norm(x, (16,), ins["b1_ln1_weight"][0], ins["b1_ln1_bias"][0], eps=1e-5)
    qkv = F.linear(ref.window_partition(t, 2), ins["b1_qkv_w"][0].reshape(48, 16),
                   ins["b1_qkv_b"][0].reshape(48)).reshape(-1, 4, 3, 2, 8).permute(2, 0, 3, 1, 4)
    assert float((qkv[0] * 8 ** -0.5 @ qkv[1].transpose(-2, -1)).max()) > 88.0
    pp = compile_pipeline(app.pipeline, batch=2, batch_capacity=2, vmem_budget=SMEM_TINY, **CPU)
    got = pp.run(ins)["swin"]
    assert torch.isfinite(got).all()
    assert _gap(got, ref.reference(ins)["swin"]) < 1e-5


def test_the_shift_is_torch_roll_and_swins_mask():
    """On a 4 x 4 map of 2 x 2 windows shifted by 1 (every shifted window
    wraps): the roll stages equal ``torch.roll`` by (-1, -1), and the
    shifted block's scores start from exactly the mask Swin builds (-100
    where the query and the key lie in different regions, else 0), window
    by window; the regular block's from 0.  So the pair is Swin's
    computation itself, not an approximation of it: no masked pair is
    dropped and none is left unmasked."""
    app = make_app("swin")
    ins = _inputs(app, 1, 5)
    pp = compile_pipeline(app.pipeline, batch=1, batch_capacity=1, **CPU)
    out = pp.run(ins)
    # per-pixel buffers are [py][wy][px][wx][c]; as a map, [y][x][c]
    as_map = lambda t: t[0].permute(1, 0, 3, 2, 4).reshape(4, 4, -1)
    x1 = as_map(out["b1_out"])
    assert torch.equal(as_map(out["roll_x"]), torch.roll(x1, shifts=(-1, -1), dims=(0, 1)))
    ref = _reference()
    mask = ref.attention_mask(4, 4, 2, 1)                    # (windows, keys, keys)
    for b, want_mask in ((1, torch.zeros_like(mask)), (2, mask)):
        st = app.pipeline.stage(f"b{b}_score")
        got = torch.zeros_like(mask)
        for wy, wx, py, px, ky, kx in itertools.product(range(2), repeat=6):
            point = {"wy": wy, "wx": wx, "py": py, "px": px, "ky": ky, "kx": kx, "h": 0}
            got[wy * 2 + wx, py * 2 + px, ky * 2 + kx] = eval_expr(st.reduction.init, point, None)
        assert torch.equal(got, want_mask)


def test_published_widths_plan():
    """At Swin-T's stage-3 widths the plan is eleven groups, the verifier
    passes: in each block LayerNorm, then the qkv linear (its output
    spilled: a window reads it at other positions), then the window
    attention, one head of one image a block, its 4 windows' 49 x 49 score
    tile and row statistics in 39,984 B of shared memory, then the
    projection, residual, LayerNorm and MLP chained through the hidden axis;
    between the blocks the roll, after them the roll back."""
    plan = _plan(PUBLISHED, batch=32, batch_capacity=32)
    assert_plan_verified(plan)
    names = [kg.name for kg in plan.kernels]
    assert names == ["b1_ln1", "b1_qkv", "b1_attn", "b1_out", "roll_x", "b2_ln1", "b2_qkv",
                     "b2_attn", "b2_out", "unroll_y", "swin"]
    win = {kg.name: kg for kg in plan.kernels if kg.window is not None}
    assert sorted(win) == ["b1_attn", "b2_attn"]
    for name, masked in (("b1_attn", 0), ("b2_attn", 3)):
        kg = win[name]
        pre = name[:2]
        assert kg.window == WindowAttention(f"{pre}_score", (f"{pre}_max", f"{pre}_den"),
                                            keys=49, windows=4, masked=masked)
        assert kg.stage_names == [f"{pre}_score", f"{pre}_max", f"{pre}_den", f"{pre}_attn"]
        assert (kg.bh, kg.grid) == (1, (32, 12))
        lg = LoweredGroup(kg)
        assert shared_bytes(lg) == kg.ws[0] * kg.bh + kg.ws[1] == 39984
        assert block_threads(lg) == 256
    chains = [kg for kg in plan.kernels if kg.chain is not None]
    assert [kg.name for kg in chains] == ["b1_out", "b2_out"]
    assert all(kg.chain.consumer.endswith("_fc2") and kg.stage_names[0].endswith("_proj")
               for kg in chains)
    # the spills: LayerNorm's output, qkv, the attention output, each
    # block's output, the roll's and the roll back's rows
    assert plan.spill_bytes() == 8730624
    # the window kernels carry their mark; the others do not
    src = emit_library([LoweredGroup(kg) for kg in plan.kernels])
    assert src.count("struct UbWindowParams") == 2 and src.count("struct UbParams") == 9


def _tampered(plan, name="b2_attn", **changes):
    kg = next(k for k in plan.kernels if k.name == name)
    kg.window = dataclasses.replace(kg.window, **changes)
    return plan


def test_verifier_refuses_broken_window_groups():
    plan = _plan(PUBLISHED)
    assert_plan_verified(plan)
    # the tile is not the group's first fused stage
    rules = {v.rule for v in verify_plan(_tampered(_plan(PUBLISHED), score="b2_max"))}
    assert "UB406" in rules
    # a statistic left out, or a count of keys the tile does not hold
    assert "UB406" in {v.rule for v in verify_plan(_tampered(_plan(PUBLISHED), stats=("b2_max",)))}
    assert "UB406" in {v.rule for v in verify_plan(_tampered(_plan(PUBLISHED), keys=48))}
    # a window tile declared on a chained group, and on a group that
    # carries rows
    plan = _plan(PUBLISHED)
    kg = next(k for k in plan.kernels if k.name == "b1_out")
    kg.window = WindowAttention("b1_proj", ("b1_res",), 49)
    assert "UB406" in {v.rule for v in verify_plan(plan)}
    plan = build_pipeline_plan(make_app("gaussian", size=30).pipeline, block_h=4)
    (kg,) = plan.kernels
    kg.window = WindowAttention("gaussian", (), 9)
    assert "UB406" in {v.rule for v in verify_plan(plan)}
    # two blocks' heads at once: the working set drifts from the plan
    plan = _plan(PUBLISHED)
    kg = next(k for k in plan.kernels if k.name == "b1_attn")
    kg.bh = 12
    assert {"UB402"} <= {v.rule for v in verify_plan(plan)}


def test_window_shape_needs_the_tile_first():
    """The recognizer takes a group's first fused stage as the tile: with
    qkv fused before it (the tiny pair under the Pallas model) it finds
    no tile."""
    plan = _plan({})
    kg = next(k for k in plan.kernels if "b1_score" in k.stage_names)
    assert kg.stage_names[0] == "b1_qkv"
    assert window_shape(kg.stages) is None and kg.window is None
    plan = _plan({}, vmem_budget=SMEM_TINY)
    kg = next(k for k in plan.kernels if "b1_score" in k.stage_names)
    assert window_shape(kg.stages) == ("b1_score", ("b1_max", "b1_den"))


COUNTERS = ("compile.window_groups", "compile.window_heads", "compile.masked_windows")


def _delta(before):
    after = telemetry.counters()
    return tuple(after.get(k, 0.0) - before.get(k, 0.0) for k in COUNTERS)


def test_compile_counts_its_window_groups():
    """A compile that misses the cache adds its window-attention groups to
    ``compile.window_groups``, the heads a block of each holds to
    ``compile.window_heads`` and their shifted windows whose keys fall in
    more than one region to ``compile.masked_windows``; a hit adds
    nothing, and a plan without a window group 0."""
    app = make_app("swin")
    before = telemetry.counters()
    compile_pipeline(app.pipeline, cache=True, vmem_budget=SMEM_TINY, **CPU)
    assert _delta(before) == (2.0, 2.0, 3.0)
    before = telemetry.counters()
    compile_pipeline(app.pipeline, cache=True, vmem_budget=SMEM_TINY, **CPU)      # a hit
    assert _delta(before) == (0.0, 0.0, 0.0)
    before = telemetry.counters()
    compile_pipeline(make_app("convnext").pipeline, cache=False, **CPU)
    assert _delta(before) == (0.0, 0.0, 0.0)


def test_make_app_knows_swin():
    app = make_app("swin")
    assert app.kind == "dnn" and app.input_extents["ifmap"] == (2, 2, 2, 2, 16)
    with pytest.raises(ValueError, match="window"):
        make_app("swin", img=5)


@pytest.mark.gpu
def test_published_widths_pair_on_card():
    """The published-width pair at batch 32 on the card: eleven launches,
    bit for bit with the plain version of the same plan (both call the
    device library's ``expf``, ``erff`` and ``sqrtf``) and within 1e-5 of
    the benchmark's plain reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    app = make_app("swin", **PUBLISHED)
    pp = compile_pipeline(app.pipeline, batch=32, batch_capacity=32)
    assert sum(k.kg.window is not None for k in pp.kernels) == 2
    ins = {n: t.cuda() for n, t in _inputs(app, 32, 39).items()}
    bufs = pp.run(ins)
    got = bufs["swin"]
    assert got.is_cuda and all(k.launches == 1 for k in pp.kernels)
    plain = dict(ins)
    for k in pp.kernels:
        plain[k.name] = k.plain(plain)
    assert torch.equal(got, plain["swin"])
    want = _reference().reference(ins)["swin"]
    scale = want.abs().flatten(1).amax(1)
    assert float(((got - want).abs().flatten(1).amax(1) / scale).max()) < 1e-5
