"""The port's eval counter and the exactly-once properties of line buffers.

``repro_torch.backend.eval_trace`` records the eval sites of each kernel's
first run inside the scope, from the group's lowering
(``LoweredGroup.eval_sites``), for both versions of a kernel.  This file
replays ``tests/test_linebuf.py``'s exactly-once cases on ``device="cpu",
kernels="eager"``, holds each case's records, as a multiset, equal to the
JAX package's ``codegen.eval_trace`` on the same app, and checks the
counter's own contract: scopes nest, a kernel records once, and outside a
scope nothing is recorded.
"""

from collections import Counter

import numpy as np
import pytest

from repro.apps.paper_apps import make_app as jax_make_app
from repro.backend import codegen as jax_codegen
from repro.backend import compile_pipeline as jax_compile
from repro_torch.apps import make_app
from repro_torch.backend import compile_pipeline, eval_trace

pytestmark = pytest.mark.torch

CPU = dict(device="cpu", kernels="eager")


def _inputs(app, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.integers(0, 16, s).astype(np.float32) for n, s in app.input_extents.items()}


def _traced_run(pp, inputs):
    with eval_trace() as trace:
        pp.run(inputs)
    return trace


def _row_multiset(records, steps, bh):
    """Global panel-row multiset of the evaluated rows: a ``step0`` site
    runs once, an ``every`` site at each grid step, ``bh`` rows further."""
    rows = Counter()
    for r in records:
        if r["when"] == "step0":
            for j in range(r["rows"]):
                rows[r["shift"] + j] += 1
        else:
            for i in range(steps):
                for j in range(r["rows"]):
                    rows[i * bh + r["shift"] + j] += 1
    return rows


def _multiset(records):
    return Counter(tuple(sorted(r.items())) for r in records)


EXACTLY_ONCE_CASES = [
    ("unsharp", {"size": 18}, {}),
    ("unsharp", {"size": 15}, {}),
    ("harris", {"schedule": "sch3", "size": 20}, {}),
    ("harris", {"schedule": "sch3", "size": 17}, {"block_h": 5}),
]
IDS = [f"{c[0]}-{i}" for i, c in enumerate(EXACTLY_ONCE_CASES)]


@pytest.mark.parametrize("name,kw,ckw", EXACTLY_ONCE_CASES, ids=IDS)
def test_linebuf_rows_computed_exactly_once(name, kw, ckw):
    app = make_app(name, **kw)
    pp = compile_pipeline(app.pipeline, line_buffer=True, **CPU, **ckw)
    lb_stages = {n for ns in pp.plan.line_buffered.values() for n in ns}
    assert lb_stages, "case must actually line-buffer something"
    trace = _traced_run(pp, _inputs(app))
    for ck in pp.kernels:
        kg = ck.kg
        steps, bh = kg.grid[0], kg.bh
        for sp in kg.stages[:-1]:
            recs = [r for r in trace if r["kernel"] == kg.name and r["stage"] == sp.name]
            rows = _row_multiset(recs, steps, bh)
            assert sum(rows.values()) == kg.eval_rows()[sp.name], sp.name
            if sp.line_buffer is None:
                continue
            lb = sp.line_buffer
            assert set(rows) == set(range(lb.lo, lb.hi + steps * bh)), sp.name
            assert all(c == 1 for c in rows.values()), (sp.name, rows)
            assert lb.hi + steps * bh - 1 >= lb.hi + kg.e0 - 1
            assert lb.lo == sp.shifts[0]


def test_recompute_mode_evaluates_overlap_rows_repeatedly():
    app = make_app("unsharp", size=18)
    pp = compile_pipeline(app.pipeline, line_buffer=False, **CPU)
    trace = _traced_run(pp, _inputs(app))
    kg = pp.kernels[0].kg
    sp = kg.stage_plan("blur_x")
    assert sp.line_buffer is None and len(sp.shifts) == 3
    recs = [r for r in trace if r["stage"] == "blur_x"]
    rows = _row_multiset(recs, kg.grid[0], kg.bh)
    assert max(rows.values()) == 3
    assert sum(rows.values()) == kg.eval_rows()["blur_x"]
    assert sum(rows.values()) > len(rows)


TRACE_CASES = [(n, kw, dict(ckw, line_buffer=lb)) for n, kw, ckw in EXACTLY_ONCE_CASES
               for lb in (True, False)] + [
    ("harris", {"schedule": "sch3", "size": 20}, {"block_w": 8, "line_buffer": True}),
    ("camera", {"size": 7}, {"block_h": 3}),
    ("matmul", {"m": 19, "n": 13, "k": 150}, {"red_grid_threshold": 64}),
]
TRACE_IDS = [f"{c[0]}-{i}" for i, c in enumerate(TRACE_CASES)]


@pytest.mark.parametrize("name,kw,ckw", TRACE_CASES, ids=TRACE_IDS)
def test_trace_equals_jax_trace(name, kw, ckw):
    """The port's records equal the JAX package's, as a multiset, on row
    and lane line buffers, recompute panels, a two-kernel plan and a grid
    reduction (whose accumulated output panel records nothing)."""
    app = make_app(name, **kw)
    ins = _inputs(app)
    want_pp = jax_compile(jax_make_app(name, **kw).pipeline, **ckw)
    with jax_codegen.eval_trace() as want:
        want_pp.run(ins)
    got = _traced_run(compile_pipeline(app.pipeline, **CPU, **ckw), ins)
    assert _multiset(got) == _multiset(want)
    assert {r["when"] for r in got} <= {"step0", "lane0", "every"}


def test_scopes_nest_and_each_kernel_records_once():
    """Records go to the innermost open scope; a kernel records on its
    first run inside a scope and never again; outside every scope a run
    records nothing."""
    app = make_app("unsharp", size=18)
    ins = _inputs(app)
    pp = compile_pipeline(app.pipeline, line_buffer=True, **CPU)
    other = compile_pipeline(make_app("gaussian", size=13).pipeline, **CPU)
    pp.run(ins)                                   # no scope: nothing recorded
    assert not pp.kernels[0].eval_recorded
    with eval_trace() as outer:
        with eval_trace() as inner:
            pp.run(ins)
        other.run(_inputs(make_app("gaussian", size=13)))
        pp.run(ins)                               # warm: records nothing
    assert inner == pp.kernels[0].lg.eval_sites() and inner
    assert outer == other.kernels[0].lg.eval_sites()
    with eval_trace() as again:
        pp.run(ins)
    assert again == []
