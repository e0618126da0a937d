"""The port's plain version against the JAX package, on the CPU.

The same seeded numpy inputs (``conftest.sweep_inputs``) go through the JAX
package's generated Pallas kernels (interpret mode, as its own tests run
them) and through the port with ``device="cpu"`` (``kernels="eager"``, the
plain PyTorch version of the hand-written CUDA kernel).  Every materialized
buffer must match the JAX result and the reference interpreter under the
conftest contract: bit-exact where ``is_exact_case`` says so, else
``rtol=1e-4, atol=1e-3``.  The cases cover the row-grid variants: padded
row grids, input rings, line buffers, fused recompute chains, strided views
and the batch grid with spare capacity (the lane and reduction grids are
``test_torch_lane_red.py``'s).
"""

import numpy as np
import pytest
import torch

from conftest import SWEEP_TOL, is_exact_case, sweep_inputs
from repro.apps.paper_apps import make_app as jax_make_app
from repro.backend import compile_pipeline as jax_compile
from repro_torch.apps import make_app
from repro_torch.backend import (
    EagerKernel,
    compile_pipeline,
    inputs_to_torch,
    max_abs_error,
    reference_arrays,
)

pytestmark = pytest.mark.torch

# (app, app kwargs, dtype, compile kwargs, variants the plan must contain)
CASES = [
    ("gaussian", {"size": 13}, "u4", {"block_h": 4}, {"padded", "ring"}),
    ("gaussian", {"size": 30}, "f32", {}, {"ring"}),
    ("harris", {"schedule": "sch3", "size": 17}, "u4", {"block_h": 5},
     {"padded", "line_buffer"}),
    ("harris", {"schedule": "sch2", "size": 19}, "i8", {"line_buffer": True},
     {"line_buffer"}),
    ("upsample", {"size": 11}, "i8", {"block_h": 4}, {"padded"}),
    ("unsharp", {"size": 15}, "u4", {"line_buffer": True}, {"ring", "line_buffer"}),
    ("unsharp", {"size": 19}, "f32", {"block_h": 5, "line_buffer": False},
     {"padded", "recompute"}),
    ("camera", {"size": 7}, "u4", {"block_h": 3}, {"padded", "recompute"}),
    ("camera", {"size": 9}, "f32", {}, set()),
    ("mobilenet", {"img": 7, "cin": 4, "cout": 4}, "u4", {"block_h": 3},
     {"padded"}),
    ("mobilenet", {"img": 6, "cin": 3, "cout": 5}, "i8", {}, set()),
    ("gaussian", {"size": 13}, "u4", {"block_h": 4, "batch": 3}, {"batch"}),
    ("unsharp", {"size": 15}, "u4",
     {"line_buffer": True, "batch": 3, "batch_capacity": 4},
     {"batch", "ring", "line_buffer"}),
    ("camera", {"size": 6}, "f32", {"batch": 2, "batch_capacity": 3}, {"batch"}),
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
        if kg.rings:
            out.add("ring")
        if kg.line_buffered:
            out.add("line_buffer")
        if any(key is not None for _sp, key in kg.scratch_entries()):
            out.add("recompute")
        if kg.batch_grid is not None:
            out.add("batch")
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
def test_eager_matches_jax_and_reference(case):
    name, kw, dtype, ckw, want_variants = case
    app = make_app(name, **kw)
    pp = compile_pipeline(app.pipeline, device="cpu", kernels="eager", **ckw)
    assert want_variants <= _variants(pp.plan)
    jpp = jax_compile(jax_make_app(name, **kw).pipeline, **ckw)
    batch = ckw.get("batch")
    ins = sweep_inputs(app, 7, dtype, batch=batch)
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


def test_max_abs_error_per_slot():
    """The port's ``max_abs_error`` runs the per-tile reference once per
    batch slot and reports the worst slot."""
    app = make_app("gaussian", size=11)
    pp = compile_pipeline(
        app.pipeline, device="cpu", kernels="eager", batch=2, batch_capacity=3
    )
    ins = sweep_inputs(app, 3, "u4", batch=2)
    assert max_abs_error(pp, ins) == {"gaussian": 0.0}


def test_eager_kernel_runs_one_group_on_given_tensors():
    """An ``EagerKernel`` is callable on its own with buffer tensors, and
    returns the group's output at the plan's extents."""
    app = make_app("unsharp", size=12)
    pp = compile_pipeline(app.pipeline, device="cpu", kernels="eager", line_buffer=True)
    (k,) = pp.kernels
    assert isinstance(k, EagerKernel)
    ins = sweep_inputs(app, 5, "u4")
    bufs = inputs_to_torch(ins, "cpu", app.pipeline)
    out = k(bufs)
    assert tuple(out.shape) == tuple(k.kg.output.nstage.pure_extents)
    assert torch.equal(out, pp(ins))


def test_inputs_to_torch_shape_checks():
    app = make_app("gaussian", size=9)
    good = sweep_inputs(app, 1, "u4")
    t = inputs_to_torch(good, "cpu", app.pipeline)
    assert t["input"].dtype == torch.float32 and t["input"].is_contiguous()
    with pytest.raises(KeyError, match="missing input"):
        inputs_to_torch({}, "cpu", app.pipeline)
    with pytest.raises(ValueError, match="rank"):
        inputs_to_torch({"input": good["input"][0]}, "cpu", app.pipeline)
    with pytest.raises(ValueError, match="declared extents"):
        inputs_to_torch({"input": good["input"][1:]}, "cpu", app.pipeline)
    with pytest.raises(ValueError, match="batch 2"):
        inputs_to_torch(good, "cpu", app.pipeline, batch=2)
