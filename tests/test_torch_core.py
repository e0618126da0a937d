"""The paper's compiler core in the port, replayed on its own copies.

``repro_torch.core.{recurrence, ubuffer, scheduling, extraction, mapping,
hwmodel, simulator}`` are copies of the JAX package's modules (none of which
imports jax).  This file replays, on those copies, the cases of
``tests/test_scheduling.py``, ``tests/test_mapping.py``,
``tests/test_property_system.py`` and the jax-free part of
``tests/test_system.py`` with the same assertions and the same hypothesis
settings; the CGRA result of the end-to-end case is held against the port's
``stencil3x3`` (its plain version, on the CPU) where the JAX test holds it
against the Pallas kernel.
"""

import math

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st

from repro_torch.apps import make_app
from repro_torch.core.extraction import extract_buffers
from repro_torch.core.hwmodel import design_cost, table2_variants
from repro_torch.core.mapping import HardwareSpec, map_design, map_unified_buffer
from repro_torch.core.poly import AffineExpr, AffineMap, Box, Schedule
from repro_torch.core.recurrence import ag_matches_affine, ag_values, make_ag
from repro_torch.core.scheduling import (
    _ii_legal,
    schedule_dnn,
    schedule_pipeline,
    schedule_sequential,
    select_policy,
)
from repro_torch.core.simulator import (
    simulate,
    validate_against_reference,
    validate_mapped_buffers,
)
from repro_torch.core.ubuffer import IN, OUT, Port, UnifiedBuffer
from repro_torch.frontend import Func, Var, execute_pipeline, lower_pipeline
from repro_torch.kernels.ops import stencil3x3_op

pytestmark = pytest.mark.torch

# ---------------------------------------------------------------------------
# tests/test_scheduling.py
# ---------------------------------------------------------------------------

PAPER_OPT = {  # Table VI, optimized completion cycles
    "gaussian": 4102,
    "harris": 4120,
    "upsample": 16387,
    "unsharp": 4119,
    "camera": 4122,
}


@pytest.mark.parametrize("name", list(PAPER_OPT))
def test_stencil_completion_matches_paper(name):
    app = make_app(name)
    sch = schedule_pipeline(app.pipeline)
    assert sch.policy == "stencil"
    assert abs(sch.completion - PAPER_OPT[name]) / PAPER_OPT[name] < 0.02


@pytest.mark.parametrize(
    "name", ["gaussian", "harris", "upsample", "unsharp", "camera", "resnet", "mobilenet"]
)
def test_all_buffers_validate(name):
    app = make_app(name)
    sch = schedule_pipeline(app.pipeline, tile_count=app.tile_count)
    ex = extract_buffers(app.pipeline, sch)
    problems = [f"{b}: {e}" for b, ub in ex.buffers.items() for e in ub.validate()]
    assert problems == []


@pytest.mark.parametrize("name", ["gaussian", "harris", "unsharp", "camera"])
def test_pipeline_speedup_over_sequential(name):
    app = make_app(name)
    opt = schedule_pipeline(app.pipeline)
    seq = schedule_sequential(app.pipeline)
    assert seq.completion / opt.completion > 5.0


def test_policy_selection():
    assert select_policy(make_app("gaussian").pipeline) == "stencil"
    assert select_policy(make_app("mobilenet").pipeline) == "stencil"
    assert select_policy(make_app("resnet").pipeline) == "dnn"


def test_resnet_dnn_pipeline():
    app = make_app("resnet")
    sch = schedule_pipeline(app.pipeline, tile_count=app.tile_count)
    seq = schedule_sequential(app.pipeline, tile_count=app.tile_count)
    assert sch.policy == "dnn"
    assert sch.ii == max(s.cycles() for s in sch.stages.values())
    assert 1.5 < seq.total_completion / sch.total_completion < 4.0
    ex = extract_buffers(app.pipeline, sch)
    assert ex.total_pe_ops() == 128


def test_harris_schedule_exploration():
    res = {}
    for sch_name in ["sch1", "sch2", "sch3", "sch4", "sch5", "sch6"]:
        app = make_app("harris", schedule=sch_name)
        s = schedule_pipeline(app.pipeline)
        ex = extract_buffers(app.pipeline, s)
        res[sch_name] = dict(cycles=s.completion, pes=ex.total_pe_ops(), bufs=len(ex.buffers))
    assert res["sch1"]["pes"] > 5 * res["sch3"]["pes"]
    assert res["sch1"]["bufs"] < res["sch3"]["bufs"]
    assert res["sch4"]["cycles"] < 0.62 * res["sch3"]["cycles"]
    assert res["sch4"]["pes"] == 2 * res["sch3"]["pes"]
    assert 3.5 < res["sch5"]["cycles"] / res["sch3"]["cycles"] < 4.5
    assert res["sch6"]["pes"] < res["sch3"]["pes"]


def test_upsample_storage_is_linebuffer_sized():
    app = make_app("upsample")
    sch = schedule_pipeline(app.pipeline)
    ex = extract_buffers(app.pipeline, sch)
    cap = ex.buffers["input"].capacity_bound()
    assert 60 <= cap <= 80


def test_unrolled_ports_deduplicate():
    app = make_app("resnet", img=6, cin=4, cout=4)
    sch = schedule_pipeline(app.pipeline, tile_count=1)
    ex = extract_buffers(app.pipeline, sch)
    assert len(ex.buffers["ifmap"].out_ports) == 4
    assert len(ex.buffers["weights"].out_ports) == 16


def test_dnn_ii_binary_search_is_tight():
    app = make_app("resnet")
    sch = schedule_dnn(app.pipeline, tile_count=app.tile_count)
    longest = max(s.cycles() for s in sch.stages.values())
    assert sch.ii == longest
    names = list(sch.stages)
    assert not _ii_legal(sch.stages, names, sch.ii - 1)


# ---------------------------------------------------------------------------
# tests/test_mapping.py
# ---------------------------------------------------------------------------


def test_downsample_example_from_figure6():
    box = Box.make(y=(0, 3), x=(0, 3))
    expr = 16 * AffineExpr.var("y") + 2 * AffineExpr.var("x")
    cfg = make_ag(expr, box)
    assert cfg.strides == (16, 2)
    assert cfg.deltas[0] == 10
    assert ag_matches_affine(expr, box)
    vals = list(ag_values(cfg))
    assert vals[:5] == [0, 2, 4, 6, 16]


@given(
    st.integers(1, 6), st.integers(1, 6), st.integers(1, 6),
    st.integers(-9, 9), st.integers(-9, 9), st.integers(-9, 9),
    st.integers(-50, 50),
)
@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
def test_recurrence_equals_affine_property(r0, r1, r2, s0, s1, s2, off):
    box = Box.make(a=(0, r0 - 1), b=(0, r1 - 1), c=(0, r2 - 1))
    expr = (
        AffineExpr.var("a") * s0 + AffineExpr.var("b") * s1
        + AffineExpr.var("c") * s2 + off
    )
    assert ag_matches_affine(expr, box)


def _mapped(name, **kw):
    app = make_app(name, **kw)
    sch = schedule_pipeline(app.pipeline, tile_count=1)
    ex = extract_buffers(app.pipeline, sch)
    return app, sch, ex, map_design(ex.buffers)


def test_gaussian_maps_to_one_mem_with_sr_chain():
    app, sch, ex, mapped = _mapped("gaussian")
    mb = mapped["input"]
    assert mb.mem_tiles == 1
    assert len(mb.sr_taps) >= 6
    assert 120 <= mb.sram_words <= 140


def test_upsample_maps_to_single_small_mem():
    app, sch, ex, mapped = _mapped("upsample")
    mb = mapped["input"]
    assert mb.mem_tiles == 1
    assert 60 <= mb.sram_words <= 80


def test_chaining_splits_large_buffers():
    app, sch, ex, mapped = _mapped("harris", size=132)
    for m in mapped.values():
        for b in m.banks:
            if b.tiles > 0:
                assert b.tiles == math.ceil(b.capacity / 2048)


def test_chaining_on_synthetic_deep_fifo():
    box = Box.make(i=(0, 4095))
    acc = AffineMap.identity(["i"])
    ub = UnifiedBuffer("fifo")
    ub.add_port(Port("w", IN, box, acc, Schedule(AffineExpr.var("i"), box)))
    ub.add_port(Port("r", OUT, box, acc, Schedule(AffineExpr.var("i") + 5000, box)))
    mb = map_unified_buffer(ub)
    assert mb.mem_tiles >= 2


def test_banking_spreads_many_ports():
    app, sch, ex, mapped = _mapped("resnet", img=8, cin=4, cout=4)
    wb = mapped["weights"]
    assert len(wb.banks) > 1


def test_hardware_spec_defaults_are_the_papers_tile():
    """``HardwareSpec`` is the same 2048-word, one-port tile the mapping
    tests above chain and bank against."""
    spec = HardwareSpec()
    assert (spec.tile_words, spec.sram_ports_per_cycle) == (2048, 1)


def test_sr_taps_have_valid_chain_structure():
    for name in ["gaussian", "harris", "unsharp"]:
        app, sch, ex, mapped = _mapped(name)
        for mb in mapped.values():
            for tap in mb.sr_taps:
                assert tap.delay >= 0
                assert tap.origin_delay >= tap.delay


APPS_SMALL = [
    ("gaussian", dict(size=12)),
    ("harris", dict(size=14)),
    ("upsample", dict(size=6)),
    ("unsharp", dict(size=10)),
    ("camera", dict(size=5)),
    ("resnet", dict(img=5, cin=2, cout=2)),
    ("mobilenet", dict(img=6, cin=2, cout=2)),
]


@pytest.mark.parametrize("name,kw", APPS_SMALL)
def test_simulation_matches_reference(name, kw):
    app = make_app(name, **kw)
    sch = schedule_pipeline(app.pipeline, tile_count=1)
    rng = np.random.default_rng(11)
    inputs = {
        n: rng.integers(1, 40, shape).astype(float)
        for n, shape in app.input_extents.items()
    }
    assert validate_against_reference(app.pipeline, sch, inputs) == []


@pytest.mark.parametrize("name,kw", APPS_SMALL)
def test_mapped_sr_chains_reproduce_streams(name, kw):
    app = make_app(name, **kw)
    sch = schedule_pipeline(app.pipeline, tile_count=1)
    ex = extract_buffers(app.pipeline, sch)
    mapped = map_design(ex.buffers)
    assert validate_mapped_buffers(ex, mapped) == []


def test_simulation_of_unrolled_schedule():
    app = make_app("harris", schedule="sch4", size=16)
    sch = schedule_pipeline(app.pipeline)
    rng = np.random.default_rng(5)
    inputs = {
        n: rng.integers(1, 40, shape).astype(float)
        for n, shape in app.input_extents.items()
    }
    assert validate_against_reference(app.pipeline, sch, inputs) == []


def test_sim_cycle_count_matches_schedule():
    app = make_app("gaussian", size=16)
    sch = schedule_pipeline(app.pipeline)
    rng = np.random.default_rng(1)
    inputs = {
        n: rng.integers(1, 9, shape).astype(float)
        for n, shape in app.input_extents.items()
    }
    sim = simulate(app.pipeline, sch, inputs)
    assert sim.cycles == sch.completion


def test_table2_ordering_matches_paper():
    v = table2_variants()
    base, ag, ub = v["dp_sram_pes"], v["dp_sram_ag"], v["wide_sp_ub"]
    assert base.total_area_um2 > ag.total_area_um2 > ub.total_area_um2
    assert base.energy_pj_per_access > ag.energy_pj_per_access > ub.energy_pj_per_access
    assert 0.35 < ub.total_area_um2 / base.total_area_um2 < 0.65
    assert 0.35 < ub.energy_pj_per_access / base.energy_pj_per_access < 0.65
    assert ub.sram_fraction < base.sram_fraction


def test_design_cost_cgra_beats_fpga():
    app, sch, ex, mapped = _mapped("gaussian")
    cost = design_cost(ex.total_pe_ops(), mapped, sch.completion, statements=62 * 62)
    assert cost.fpga_energy_per_op_pj / cost.cgra_energy_per_op_pj > 2.0
    assert cost.fpga_runtime_s / cost.cgra_runtime_s == pytest.approx(4.5)


# ---------------------------------------------------------------------------
# tests/test_property_system.py (the jax-free properties)
# ---------------------------------------------------------------------------

x, y = Var("x"), Var("y")


def build_random_pipeline(stage_specs, size):
    """stage_specs: list of lists of (dx, dy, weight) taps per stage."""
    inp = Func.input("input", 2)
    prev = inp
    funcs = [inp]
    halo = 0
    for i, taps in enumerate(stage_specs):
        f = Func(f"s{i}")
        acc = None
        for dx, dy, w in taps:
            t = prev[x + dx, y + dy] * w
            acc = t if acc is None else acc + t
        f[x, y] = acc
        f.store_root()
        funcs.append(f)
        prev = f
        halo += max(max(dx, dy) for dx, dy, _ in taps)
    out_sz = size - halo
    funcs[-1].hw_accelerate()
    pipe = lower_pipeline(funcs[-1], funcs, {"x": out_sz, "y": out_sz})
    return pipe, funcs, out_sz


taps_strategy = st.lists(
    st.tuples(st.integers(0, 2), st.integers(0, 2), st.integers(-3, 3).filter(lambda w: w != 0)),
    min_size=1, max_size=4, unique_by=lambda t: (t[0], t[1]),
)
pipeline_strategy = st.lists(taps_strategy, min_size=1, max_size=3)


@given(pipeline_strategy, st.integers(0, 10_000))
@settings(max_examples=25, deadline=None)
def test_random_stencil_pipeline_invariants(stage_specs, seed):
    size = 14
    pipe, funcs, out_sz = build_random_pipeline(stage_specs, size)
    if out_sz < 4:
        return
    sched = schedule_pipeline(pipe)
    ex = extract_buffers(pipe, sched)
    problems = [e for ub in ex.buffers.values() for e in ub.validate()]
    assert problems == [], (stage_specs, problems)
    seq = schedule_sequential(pipe)
    assert sched.completion <= seq.completion
    mapped = map_design(ex.buffers)
    assert validate_mapped_buffers(ex, mapped) == []
    rng = np.random.default_rng(seed)
    in_shape = pipe.buffer_boxes["input"].extents
    inputs = {"input": rng.integers(-8, 8, in_shape).astype(np.float64)}
    assert validate_against_reference(pipe, sched, inputs) == []
    words = sum(m.sram_words for m in mapped.values())
    seq_words = sum(pipe.buffer_boxes[b].size() for b in ex.buffers)
    assert words <= max(seq_words, 1) * 2


@given(
    st.integers(2, 5), st.integers(2, 5), st.integers(1, 4),
    st.integers(-6, 6), st.integers(0, 50),
)
@settings(max_examples=40, deadline=None)
def test_recurrence_ag_random_2d(rx, ry, sx, sy, off):
    box = Box.make(y=(0, ry - 1), x=(0, rx - 1))
    expr = AffineExpr.var("x") * sx + AffineExpr.var("y") * sy + off
    assert ag_matches_affine(expr, box)


# ---------------------------------------------------------------------------
# tests/test_system.py (the paper path)
# ---------------------------------------------------------------------------


def test_paper_pipeline_end_to_end():
    """DSL -> scheduled -> extracted -> mapped -> simulated == reference ==
    the port's stencil3x3 (its plain version, on the CPU)."""
    full = make_app("gaussian")
    fsched = schedule_pipeline(full.pipeline)
    fex = extract_buffers(full.pipeline, fsched)
    fmapped = map_design(fex.buffers)
    assert sum(m.mem_tiles for m in fmapped.values()) >= 1

    app = make_app("gaussian", size=18)
    sched = schedule_pipeline(app.pipeline)
    seq = schedule_sequential(app.pipeline)
    assert sched.completion < seq.completion / 3

    ex = extract_buffers(app.pipeline, sched)
    mapped = map_design(ex.buffers)

    rng = np.random.default_rng(0)
    inputs = {
        n: rng.integers(0, 64, s).astype(np.float32)
        for n, s in app.input_extents.items()
    }
    assert validate_against_reference(app.pipeline, sched, inputs) == []
    assert validate_mapped_buffers(ex, mapped) == []

    vals = execute_pipeline(app.pipeline, inputs)
    cgra = np.zeros((16, 16), np.float32)
    for idx, v in vals["gaussian"].items():
        cgra[idx] = v
    w = torch.tensor(np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]]) / 16.0, dtype=torch.float32)
    got = stencil3x3_op(torch.from_numpy(inputs["input"]), w, kernels="eager")
    np.testing.assert_allclose(got.numpy(), cgra, rtol=1e-5)
