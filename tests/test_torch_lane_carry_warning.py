"""The port's ``compile_pipeline`` names a lane-carry degrade, as the JAX
package's does.

``line_buffer=True`` on a lane-blocked kernel that cannot carry its halo
across lane steps must not degrade silently: the planner records the
reason in ``KernelGroup.notes["lane_carry"]`` (a full degrade) or
``notes["lane_carry_shed"]`` (part of the carry shed), and
``compile_pipeline`` warns with ``LaneCarryDegradeWarning``, attributed to
its caller.  These are the cases of ``tests/test_linebuf.py``'s
``test_lane_carry_degrade_warns_with_named_reason``, replayed on the plain
PyTorch version on the CPU; the degraded plan stays right.
"""

import os
import warnings

import numpy as np
import pytest

from repro_torch.apps import make_app
from repro_torch.backend import compile_pipeline, max_abs_error
from repro_torch.backend.errors import LaneCarryDegradeWarning

pytestmark = pytest.mark.torch

ME = os.path.basename(__file__)
EAGER = dict(device="cpu", kernels="eager", line_buffer=True)


def _inputs(app, seed=0):
    rng = np.random.default_rng(seed)
    return {
        name: rng.integers(0, 16, shape).astype(np.float32)
        for name, shape in app.input_extents.items()
    }


@pytest.mark.parametrize("app_kw,block_w,match", [
    # a one-lane block cannot hold the 2-column halo: a full degrade
    (("gaussian", {"size": 24, "width": 40}), 1, "halo-exceeds-bw"),
    # two lanes hold some of harris's halos, not all: part of the carry shed
    (("harris", {"schedule": "sch3", "size": 20}), 2, "shed part of the carry"),
], ids=["full-degrade", "partial-shed"])
def test_lane_carry_degrade_warns_with_named_reason(app_kw, block_w, match):
    name, kw = app_kw
    app = make_app(name, **kw)
    with pytest.warns(LaneCarryDegradeWarning, match=match) as rec:
        pp = compile_pipeline(app.pipeline, block_w=block_w, **EAGER)
    # stacklevel 3: the warning points at this file, the caller of
    # compile_pipeline, not at the runner
    hits = [w for w in rec if issubclass(w.category, LaneCarryDegradeWarning)]
    assert hits and all(os.path.basename(w.filename) == ME for w in hits)
    if block_w == 1:
        assert not any(r.lane for kg in pp.plan.kernels for r in kg.rings)
    # degraded, the plan still computes the pipeline (bit-exact on integers
    # for gaussian; harris divides, within the reference's 1e-3)
    assert max(max_abs_error(pp, _inputs(app)).values()) <= 1e-3


def test_carried_lane_plan_stays_silent():
    app = make_app("harris", schedule="sch3", size=20)
    with warnings.catch_warnings():
        warnings.simplefilter("error", LaneCarryDegradeWarning)
        pp = compile_pipeline(app.pipeline, block_w=8, **EAGER)
    assert any(r.lane for kg in pp.plan.kernels for r in kg.rings)


def test_auto_line_buffer_never_warns():
    """Only an explicit request is owed a warning: ``"auto"`` arbitrates."""
    app = make_app("gaussian", size=24, width=40)
    with warnings.catch_warnings():
        warnings.simplefilter("error", LaneCarryDegradeWarning)
        compile_pipeline(app.pipeline, block_w=1, device="cpu", kernels="eager")
