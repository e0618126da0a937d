"""The port's copy of the planner plans exactly what the JAX package plans.

``repro_torch`` keeps its own copies of the planner, verifier and frontend
(it imports nothing of ``repro``), so every plan it builds must match the
JAX planner's digest for digest: block heights, grids, fused stages, view
groups, rings, line buffers, bindings, scratch and HBM bytes.  Checked on
the port's full-size serving configurations and on every case of the
deterministic shape sweep (``conftest.generate_sweep_cases``); the copied
golden tables hold on the port's own plans.
"""

import dataclasses

import pytest

from conftest import generate_sweep_cases, sweep_case_id
from repro.apps.paper_apps import make_app as jax_make_app
from repro.backend.plan import build_pipeline_plan as jax_build_plan
from repro.backend.verify import verify_plan as jax_verify_plan
from repro_torch.apps import make_app
from repro_torch.backend.golden import check_linebuf_plan, check_plan_verified, expected_plan_shape
from repro_torch.backend.plan import build_pipeline_plan
from repro_torch.backend.verify import verify_plan
from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK

pytestmark = pytest.mark.torch

# the port's serving configurations (chip_smoke.py's full sizes), each with
# the generated-kernel variant its plan must take at the H100 budget:
# "rows" (row grid only), "lane" (lane grid, nothing carried), "red" (grid
# reduction with a masked K-tail) or "lane-carry" (lane grid with column
# rings and lane line buffers)
SLICE_CONFIGS = [
    ("gaussian", {"size": 1082, "width": 1922}, "rows"),
    ("harris", {"schedule": "sch3", "size": 1024}, "rows"),
    ("unsharp", {"size": 1024}, "rows"),
    ("camera", {"size": 512}, "rows"),
    ("upsample", {"size": 1024}, "rows"),
    ("resnet", {"img": 56, "cin": 64, "cout": 64}, "lane"),
    ("mobilenet", {"img": 112, "cin": 32, "cout": 64}, "rows"),
    ("matmul", {"m": 256, "n": 256, "k": 1000}, "red"),
    ("harris", {"schedule": "sch3", "size": 2048}, "lane-carry"),
]
SLICE_IDS = [
    "gaussian", "harris", "unsharp", "camera", "upsample",
    "resnet", "mobilenet", "matmul", "harris2048",
]

SWEEP = generate_sweep_cases()


def _dc(x):
    return None if x is None else dataclasses.astuple(x)


def plan_digest(plan):
    """A structural digest of a plan, built from plain values so plans of
    the two packages (distinct classes) compare equal."""
    out = []
    for kg in plan.kernels:
        stages = tuple(
            (
                sp.name, sp.streamed, tuple(sp.shifts), _dc(sp.line_buffer),
                tuple(sp.load_kind), tuple(sp.scratch_producer),
                tuple(tuple(sorted(b.items())) for b in sp.view_binding),
                tuple(tuple(sorted(b.items())) for b in sp.ring_binding),
                tuple(sp.blocked_axis_of), tuple(sp.lane_shifts),
            )
            for sp in kg.stages
        )
        out.append((
            kg.bh, tuple(kg.grid), tuple(kg.stage_names), stages,
            tuple(_dc(g) for g in kg.groups),
            tuple(_dc(r) for r in kg.rings),
            kg.scratch_bytes, kg.hbm_bytes(), kg.bw,
            _dc(kg.padded_grid), _dc(kg.lane_grid), _dc(kg.batch_grid),
            _dc(kg.red_grid),
        ))
    return out


def _variant(kg):
    if kg.red_grid is not None:
        assert kg.lane_grid is None and kg.red_grid.padded
        return "red"
    if kg.lane_grid is None:
        return "rows"
    carried = kg.rings or kg.line_buffered
    assert all(r.lane for r in kg.rings)
    assert all(sp.line_buffer.lane for sp in kg.stages if sp.line_buffer is not None)
    return "lane-carry" if carried else "lane"


@pytest.mark.parametrize("batch", [None, 8])
@pytest.mark.parametrize("name,kw,variant", SLICE_CONFIGS, ids=SLICE_IDS)
def test_slice_configs_plan_identically(name, kw, variant, batch):
    ckw = {"vmem_budget": H100_SMEM_PER_BLOCK}
    if batch:
        ckw.update(batch=batch, batch_capacity=batch)
    ours = build_pipeline_plan(make_app(name, **kw).pipeline, **ckw)
    ref = jax_build_plan(jax_make_app(name, **kw).pipeline, **ckw)
    assert plan_digest(ours) == plan_digest(ref)
    assert verify_plan(ours) == [] and jax_verify_plan(ref) == []
    # each configuration takes the generated-kernel variant it is served for
    for kg in ours.kernels:
        assert _variant(kg) == variant
        assert kg.scratch_bytes <= H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("case", SWEEP, ids=[sweep_case_id(c) for c in SWEEP])
def test_sweep_case_plans_identically(case):
    name, kw, _dtype, fuse, ckw = case
    ours = build_pipeline_plan(make_app(name, **kw).pipeline, fuse=fuse, **ckw)
    ref = jax_build_plan(jax_make_app(name, **kw).pipeline, fuse=fuse, **ckw)
    assert plan_digest(ours) == plan_digest(ref)
    assert verify_plan(ours) == [] and jax_verify_plan(ref) == []


# the demo sizes the golden tables pin (tests/test_linebuf.py GOLDEN_SIZES)
GOLDEN_SIZES = {
    ("harris", "sch3"): {"schedule": "sch3", "size": 20},
    ("harris", "sch2"): {"schedule": "sch2", "size": 20},
    ("unsharp", None): {"size": 18},
    ("camera", None): {"size": 16},
    ("mobilenet", None): {"img": 8, "cin": 4, "cout": 4},
}


@pytest.mark.parametrize("key", sorted(GOLDEN_SIZES, key=str), ids=lambda k: f"{k[0]}-{k[1]}")
def test_copied_golden_contract_holds(key):
    """The port's copy of the golden tables certifies the port's plans: the
    fused kernel counts, the carry decisions and a clean verifier."""
    name, _sched = key
    pipe = make_app(name, **GOLDEN_SIZES[key]).pipeline
    plan = build_pipeline_plan(pipe)
    plan_rc = build_pipeline_plan(pipe, line_buffer=False)
    assert (plan.n_stages, plan.n_kernels) == expected_plan_shape(*key)
    assert check_linebuf_plan(name, key[1], plan, plan_rc) == []
    assert check_plan_verified(name, plan) == []
