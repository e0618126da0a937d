"""The port's grid-reduction, lane-grid and column-carry variants, on the CPU.

Variants (c), (e) and (f) of the generated group kernel: a reduction dim
lifted into the grid (resident or chunk-streamed operands, masked K-tail),
lane grids with masked lane tails and per-(row, lane)-shift recompute
panels, and column rings and lane line buffers rotating per lane step.  The
same seeded numpy inputs (``conftest.sweep_inputs``) go through the JAX
package's generated Pallas kernels (interpret mode, as its own tests run
them) and through the port's plain version (``device="cpu"``,
``kernels="eager"``).  Contract (``conftest``): bit-exact where
``is_exact_case`` says so, else ``rtol=1e-4, atol=SWEEP_TOL``.  A second
test holds the port against the reference interpreter on every sweep case
whose plan has a lane or reduction grid.
"""

import numpy as np
import pytest
import torch

from conftest import SWEEP_TOL, generate_sweep_cases, is_exact_case, sweep_case_id, sweep_inputs
from repro.apps.paper_apps import make_app as jax_make_app
from repro.backend import compile_pipeline as jax_compile
from repro_torch.apps import make_app
from repro_torch.backend import compile_pipeline, reference_arrays

pytestmark = pytest.mark.torch

# (app, app kwargs, dtype, compile kwargs, variants the plan must contain)
CASES = [
    ("gaussian", {"size": 26}, "u4", {"block_w": 9, "line_buffer": True},
     {"lane", "lane_pad", "column_ring"}),
    ("harris", {"schedule": "sch3", "size": 25}, "u4",
     {"block_h": 9, "block_w": 5, "line_buffer": True},
     {"lane", "column_ring", "lane_line_buffer", "lane_recompute"}),
    ("resnet", {"img": 8, "cin": 4, "cout": 4}, "u4", {"block_w": 3},
     {"lane", "lane_pad"}),
    ("matmul", {"m": 8, "n": 13, "k": 149}, "u4",
     {"red_grid_threshold": 64, "block_h": 6}, {"red", "k_tail", "resident"}),
    ("matmul", {"m": 19, "n": 13, "k": 70}, "u4",
     {"red_grid_threshold": 64, "red_resident": False}, {"red", "streamed_chunk"}),
    ("harris", {"schedule": "sch3", "size": 20}, "f32",
     {"block_w": 8, "line_buffer": True}, {"lane", "column_ring", "lane_line_buffer"}),
    ("unsharp", {"size": 19}, "u4", {"block_w": 5, "line_buffer": True},
     {"lane", "lane_pad", "padded", "column_ring"}),
    ("camera", {"size": 9}, "f32", {"block_w": 4}, {"lane", "column_ring"}),
    ("gaussian", {"size": 33, "width": 255}, "i8", {"block_w": 128, "line_buffer": True},
     {"lane", "lane_pad", "column_ring"}),
    ("matmul", {"m": 19, "n": 23, "k": 7}, "u4", {"block_w": 6, "block_h": 4},
     {"lane", "lane_pad", "padded"}),
    ("matmul", {"m": 19, "n": 13, "k": 70}, "u4",
     {"red_grid_threshold": 64, "batch": 3, "batch_capacity": 4}, {"red", "batch"}),
    ("harris", {"schedule": "sch3", "size": 21}, "u4",
     {"block_w": 6, "block_h": 5, "line_buffer": True, "batch": 3, "batch_capacity": 4},
     {"lane", "column_ring", "lane_line_buffer", "batch"}),
]


def _case_id(c):
    name, kw, dtype, ckw, _ = c
    bits = [name] + [str(v) for v in kw.values()] + [dtype]
    bits += [f"{k}{v}" for k, v in ckw.items()]
    return "-".join(bits)


def _variants(plan):
    out = set()
    for kg in plan.kernels:
        if kg.padded_grid is not None:
            out.add("padded")
        if kg.batch_grid is not None:
            out.add("batch")
        if kg.lane_grid is not None:
            out.add("lane")
            if kg.lane_grid.pad:
                out.add("lane_pad")
        rg = kg.red_grid
        if rg is not None:
            out.add("red")
            if rg.padded:
                out.add("k_tail")
            for g in kg.groups:
                if g.red_axis is not None:
                    out.add("resident" if g.resident else "streamed_chunk")
        if any(r.lane for r in kg.rings):
            out.add("column_ring")
        for sp, key in kg.scratch_entries():
            if isinstance(key, tuple):
                out.add("lane_line_buffer" if key[1] is None else "lane_recompute")
    return out


def _reference(app, ins, batch):
    if batch is None:
        return reference_arrays(app.pipeline, ins)
    per_slot = [
        reference_arrays(app.pipeline, {n: a[b] for n, a in ins.items()})
        for b in range(batch)
    ]
    return {k: np.stack([p[k] for p in per_slot]) for k in per_slot[0]}


def _close(got, want, exact, label):
    if exact:
        assert np.array_equal(got, want), (
            f"{label}: not bit-exact; max err {np.max(np.abs(got - want))}"
        )
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=SWEEP_TOL, err_msg=label)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_plain_version_matches_jax_and_reference(case):
    name, kw, dtype, ckw, want_variants = case
    app = make_app(name, **kw)
    pp = compile_pipeline(app.pipeline, device="cpu", kernels="eager", **ckw)
    assert want_variants <= _variants(pp.plan), _variants(pp.plan)
    jpp = jax_compile(jax_make_app(name, **kw).pipeline, **ckw)
    batch = ckw.get("batch")
    ins = sweep_inputs(app, 11, dtype, batch=batch)
    got = pp.run(ins)
    jgot = jpp.run(ins)
    want = _reference(app, ins, batch)
    exact = is_exact_case(name, dtype)
    assert [k.name for k in pp.kernels] == [k.name for k in jpp.kernels]
    for k in pp.kernels:
        g = got[k.name]
        assert g.device.type == "cpu" and g.dtype == torch.float32
        g = g.numpy()
        _close(g, np.asarray(jgot[k.name]), exact, f"{k.name} vs JAX")
        _close(g.astype(np.float64), want[k.name], exact, f"{k.name} vs reference")


# every sweep case that forces a lane block or lowers the grid-reduction
# threshold: exactly the sweep cases whose plans have a lane or reduction
# grid (the test asserts it)
LANE_RED_SWEEP = [
    c for c in generate_sweep_cases()
    if "block_w" in c[4] or "red_grid_threshold" in c[4]
]


@pytest.mark.parametrize("case", LANE_RED_SWEEP, ids=[sweep_case_id(c) for c in LANE_RED_SWEEP])
def test_sweep_lane_and_reduction_cases_match_reference(case):
    name, kw, dtype, fuse, ckw = case
    app = make_app(name, **kw)
    pp = compile_pipeline(app.pipeline, device="cpu", kernels="eager", fuse=fuse, **ckw)
    assert any(
        kg.lane_grid is not None or kg.red_grid is not None for kg in pp.plan.kernels
    )
    batch = ckw.get("batch")
    ins = sweep_inputs(app, 5, dtype, batch=batch)
    got = pp.run(ins)
    want = _reference(app, ins, batch)
    exact = is_exact_case(name, dtype)
    for k in pp.kernels:
        g = got[k.name].numpy().astype(np.float64)
        assert g.shape == want[k.name].shape
        _close(g, want[k.name], exact, f"{sweep_case_id(case)}: {k.name} vs reference")
