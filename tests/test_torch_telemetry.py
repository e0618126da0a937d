"""The port's spans and counters (``repro_torch.telemetry``) on the CPU.

Spans record only under a ``torch.profiler`` session, on the clock kineto
stamps its events with, and never reach the profiler's own event list; the
serve bridge and the runner record their phases; the compile counters rise
on a cache miss only.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.apps import make_app
from repro_torch.backend import PipelineServer, compile_pipeline

pytestmark = pytest.mark.torch

CPU = dict(device="cpu", kernels="eager")
SERVE_SPANS = {"serve.admit", "serve.queued", "serve.step", "serve.stack", "serve.h2d",
               "pipeline.run", "serve.d2h", "serve.scan"}


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def _tiles(app, n):
    rng = np.random.default_rng(7)
    return [{name: rng.random(app.input_extents[name], np.float32) for name in app.input_extents}
            for _ in range(n)]


def test_without_a_profiler_span_records_nothing():
    assert not telemetry.recording()
    with telemetry.span("outer", a=1) as sp:
        assert sp is telemetry.OFF and not sp
        sp.set(b=2)
        with telemetry.span("inner") as inner:
            assert inner is telemetry.OFF
    assert telemetry.spans() == []


def test_nested_spans_record_their_parents():
    with _profiler():
        with telemetry.span("outer", a=1) as outer:
            assert outer
            with telemetry.span("inner"):
                pass
            with telemetry.span("inner"):
                outer.set(b=2)
    inner1, inner2, out = telemetry.spans()
    assert [s.name for s in (inner1, inner2, out)] == ["inner", "inner", "outer"]
    assert out.parent is None and out.attrs == {"a": 1, "b": 2}
    assert inner1.parent == inner2.parent == out.id
    assert len({inner1.id, inner2.id, out.id}) == 3
    assert out.start_ns <= inner1.start_ns <= inner1.end_ns <= inner2.start_ns
    assert inner2.end_ns <= out.end_ns


def test_a_kineto_event_lies_inside_the_span_around_it():
    a = torch.ones(1000)
    with _profiler() as prof:
        with telemetry.span("around"):
            a + a
    (sp,) = telemetry.spans()
    adds = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::add"]
    assert adds
    for e in adds:
        assert sp.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= sp.end_ns


def test_spans_never_reach_the_profilers_event_list():
    app = make_app("gaussian", size=9)
    srv = PipelineServer(app.pipeline, batch_slots=4, **CPU)
    with _profiler() as prof:
        srv.run(_tiles(app, 6))
    assert {s.name for s in telemetry.spans()} == SERVE_SPANS
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    names |= {e.key for e in prof.key_averages()}
    assert not {n for n in names if n.startswith(("serve.", "pipeline."))}


def test_dropped_counts_spans_past_the_limit(monkeypatch):
    monkeypatch.setattr(telemetry, "LIMIT", 3)
    with _profiler():
        for _ in range(5):
            with telemetry.span("s"):
                pass
    telemetry.record("queued", 1, 2)
    assert len(telemetry.spans()) == 3 and telemetry.dropped == 3
    telemetry.reset()
    assert telemetry.spans() == [] and telemetry.dropped == 0


def test_served_requests_record_each_phase_and_their_ids():
    app = make_app("gaussian", size=9)
    srv = PipelineServer(app.pipeline, batch_slots=4, **CPU)
    with _profiler():
        reqs = srv.run(_tiles(app, 6))
    assert all(r.ok for r in reqs)
    rec = telemetry.spans()
    by = Counter(s.name for s in rec)
    assert by == {"serve.admit": 6, "serve.queued": 6, "serve.step": 2, "serve.stack": 2,
                  "serve.h2d": 2, "pipeline.run": 2, "serve.d2h": 2, "serve.scan": 2}
    steps = [s for s in rec if s.name == "serve.step"]
    assert sum(s.attrs["live"] for s in steps) == srv.served == 6
    assert [s.attrs["live"] for s in steps] == [4, 2]
    rids = [r.rid for r in reqs]
    assert len(set(rids)) == 6
    admit = {s.attrs["rid"]: s for s in rec if s.name == "serve.admit"}
    queued = {s.attrs["rid"]: s for s in rec if s.name == "serve.queued"}
    assert list(admit) == list(queued) == rids
    assert [r for s in steps for r in s.attrs["rids"]] == rids
    # a request waits from the end of its admission to the start of the step that takes it
    for rid, step in zip(rids, [steps[0]] * 4 + [steps[1]] * 2):
        assert admit[rid].end_ns <= queued[rid].start_ns <= queued[rid].end_ns == step.start_ns
    # the dispatch's phases lie inside their step, in order
    ids = {s.id for s in steps}
    inner = [s for s in rec if s.name in SERVE_SPANS - {"serve.admit", "serve.queued", "serve.step"}]
    assert all(s.parent in ids for s in inner)
    first = sorted((s for s in inner if s.parent == steps[0].id), key=lambda s: s.start_ns)
    assert [s.name for s in first] == ["serve.stack", "serve.h2d", "pipeline.run",
                                       "serve.d2h", "serve.scan"]


def test_a_queued_wait_needs_both_ends_inside_the_session():
    app = make_app("gaussian", size=9)
    srv = PipelineServer(app.pipeline, batch_slots=4, **CPU)
    tiles = _tiles(app, 3)
    before = srv.submit(tiles[0])
    with _profiler():
        srv.step()                   # admitted before the session: no wait kept
        during = srv.submit(tiles[1])
    srv.step()                       # the session has ended: no wait kept either
    with _profiler():
        inside = srv.submit(tiles[2])
        srv.step()
    assert before.ok and during.ok and inside.ok
    waits = [s for s in telemetry.spans() if s.name == "serve.queued"]
    assert [s.attrs for s in waits] == [{"rid": inside.rid}]
    assert during.queued_ns is None and inside.queued_ns is None


def test_admission_does_not_cover_the_wait_for_room():
    app = make_app("gaussian", size=9)
    srv = PipelineServer(app.pipeline, batch_slots=2, max_pending=1, admission="block", **CPU)
    a, b = _tiles(app, 2)
    with _profiler():
        srv.submit(a)
        second = srv.submit(b)       # waits for room: one step runs inside submit
    rec = telemetry.spans()
    (step,) = [s for s in rec if s.name == "serve.step"]
    admit = [s for s in rec if s.name == "serve.admit"]
    assert step.parent is None and step.attrs["live"] == 1
    assert admit[1].attrs["rid"] == second.rid and admit[1].end_ns <= step.start_ns
    # the first request's wait ended at that step; the second is still queued
    assert [s.attrs["rid"] for s in rec if s.name == "serve.queued"] == [step.attrs["rids"][0]]
    assert second.rid not in step.attrs["rids"]


def test_resident_runs_record_pipeline_run():
    app = make_app("gaussian", size=9)
    pp = compile_pipeline(app.pipeline, batch=2, batch_capacity=2, cache=True, **CPU)
    ins = {n: torch.from_numpy(np.stack([t[n] for t in _tiles(app, 2)])) for n in app.input_extents}
    pp.run(ins)
    with _profiler():
        for _ in range(3):
            pp.run(ins)
    rec = telemetry.spans()
    assert [s.name for s in rec] == ["pipeline.run"] * 3
    assert all(s.parent is None and s.end_ns >= s.start_ns for s in rec)


def test_compile_counters_rise_on_a_miss_only():
    app = make_app("gaussian", size=11)
    keys = ("compile.plan_s", "compile.verify_s", "compile.build_s")
    before = telemetry.counters()
    compile_pipeline(app.pipeline, cache=False, **CPU)         # always compiles
    after = telemetry.counters()
    assert all(after[k] > before.get(k, 0.0) for k in keys)
    compile_pipeline(app.pipeline, cache=True, **CPU)          # a miss or a hit
    warm = telemetry.counters()
    compile_pipeline(app.pipeline, cache=True, verify=True, **CPU)   # a hit
    assert telemetry.counters() == warm
    assert telemetry.spans() == []                             # counters only


def test_plan_counters_count_plans_and_their_spills():
    """A compile that misses the cache adds 1 to ``compile.plans`` and the
    plan's spill to ``compile.spill_bytes_per_img``; a hit adds nothing.
    MobileNet v1's 14x14x512 block fuses into one group (its depthwise
    output stays in shared memory: no spill); forced to split, the
    depthwise output is written once and read back once."""
    keys = ("compile.plans", "compile.spill_bytes_per_img")

    def delta(before):
        after = telemetry.counters()
        return tuple(after.get(k, 0.0) - before.get(k, 0.0) for k in keys)

    block = make_app("mobilenet", img=14, cin=512, cout=512)
    before = telemetry.counters()
    pp = compile_pipeline(block.pipeline, batch=32, batch_capacity=32, cache=True, **CPU)
    assert len(pp.kernels) == 1
    assert delta(before) == (1.0, 0.0)
    before = telemetry.counters()
    compile_pipeline(block.pipeline, batch=32, batch_capacity=32, cache=True, **CPU)  # a hit
    assert delta(before) == (0.0, 0.0)

    small = make_app("mobilenet", img=6, cin=8, cout=8)
    before = telemetry.counters()
    pp = compile_pipeline(small.pipeline, fuse=False, cache=False, **CPU)
    assert [k.name for k in pp.kernels] == ["dw_conv", "mobilenet"]
    assert delta(before) == (1.0, 2 * 4 * 6 * 6 * 8)


def test_element_parallel_counters_count_the_tiled_groups():
    """A compile adds its element-parallel groups to ``compile.ep_groups``
    and those that take the two-axis tile to ``compile.ep_tiled_groups``:
    ResNet-18's conv2_x (a reduction over input channels and taps, whose
    weights do not vary along the thread axis) adds 1 to each; upsample
    (no reduction) 0 and 1."""
    keys = ("compile.ep_groups", "compile.ep_tiled_groups")

    def delta(before):
        after = telemetry.counters()
        return tuple(after.get(k, 0.0) - before.get(k, 0.0) for k in keys)

    conv = make_app("resnet", img=56, cin=64, cout=64)
    before = telemetry.counters()
    compile_pipeline(conv.pipeline, batch=8, batch_capacity=8, cache=False, **CPU)
    assert delta(before) == (1.0, 1.0)
    before = telemetry.counters()
    compile_pipeline(make_app("upsample", size=64).pipeline, cache=False, **CPU)
    assert delta(before) == (1.0, 0.0)
