"""The metrics that read what the port records of itself
(``repro_torch.telemetry``): each reader on synthetic spans and counters,
nothing where the program records nothing or has no such module, and a
traced tiny run of each cell that lists and reads them."""

import sys

import pytest

from portbench import spec

from .conftest import CELLS, run_tiny, tiny_cell

MS = 1_000_000          # ns
SPAN_METRICS = {
    "serve": ["serve_admit_ms_per_img", "serve_stack_ms_per_img", "serve_copy_ms_per_img",
              "serve_scan_ms_per_img", "queue_wait_ms_p95"],
    "resident": ["pipeline_run_us.resident"],
}
SETUP = ["setup_plan_s", "setup_build_s"]


@pytest.fixture
def telemetry():
    from repro_torch import telemetry

    telemetry.reset()
    yield telemetry
    telemetry.reset()


def read(name):
    return spec.reader(name)({})


def _steps(t, lives, t0=0):
    """``serve.step`` spans of 10 ms with ``lives`` requests each, every
    phase inside at a fixed length: admit 1 ms a request, stack 2, h2d 3,
    d2h 4, scan 0.5 (ms)."""
    for i, live in enumerate(lives):
        a = t0 + 20 * MS * i
        for r in range(live):
            t.record("serve.admit", a - MS, a, rid=r)
        for name, ms in (("serve.stack", 2), ("serve.h2d", 3), ("serve.d2h", 4)):
            t.record(name, a, a + ms * MS)
        t.record("serve.scan", a, a + MS // 2)
        t.record("serve.step", a, a + 10 * MS, live=live, rids=list(range(live)))


def test_per_image_readers_divide_by_the_requests_the_steps_took(telemetry):
    _steps(telemetry, [8, 4, 0])
    served = 12
    assert read("serve_admit_ms_per_img.open") == pytest.approx(12 * 1.0 / served)
    assert read("serve_stack_ms_per_img.closed") == pytest.approx(3 * 2.0 / served)
    assert read("serve_copy_ms_per_img.open") == pytest.approx(3 * (3.0 + 4.0) / served)
    assert read("serve_scan_ms_per_img.closed") == pytest.approx(3 * 0.5 / served)
    for base in SPAN_METRICS["serve"][:4]:
        assert read(base + ".open") == read(base + ".closed")


def test_queue_wait_is_the_nearest_rank_p95(telemetry):
    for i in range(1, 101):                       # 1..100 ms, out of order
        telemetry.record("serve.queued", 0, ((i * 37) % 100 + 1) * MS, rid=i)
    assert read("queue_wait_ms_p95.open") == pytest.approx(95.0)
    assert read("queue_wait_ms_p95.closed") == pytest.approx(95.0)


def test_pipeline_run_is_the_mean_of_its_spans(telemetry):
    for us in (40, 60, 80):
        telemetry.record("pipeline.run", 10**9, 10**9 + us * 1000)
    assert read("pipeline_run_us.resident") == pytest.approx(60.0)


def test_setup_readers_sum_the_compile_counters(telemetry, monkeypatch):
    monkeypatch.setattr(telemetry, "counters", lambda: {
        "compile.plan_s": 0.5, "compile.verify_s": 0.25, "compile.build_s": 4.0})
    assert read("setup_plan_s") == pytest.approx(0.75)
    assert read("setup_build_s") == pytest.approx(4.0)
    monkeypatch.setattr(telemetry, "counters", lambda: {"compile.verify_s": 0.25})
    assert read("setup_plan_s") == pytest.approx(0.25)
    assert read("setup_build_s") is None


def test_nothing_recorded_reads_nothing(telemetry, monkeypatch):
    names = [b + ".open" for b in SPAN_METRICS["serve"]] + SPAN_METRICS["resident"]
    assert all(read(n) is None for n in names)
    # steps that took no request give no per-image value
    _steps(telemetry, [0, 0])
    assert read("serve_stack_ms_per_img.open") is None
    monkeypatch.setattr(telemetry, "counters", lambda: {})
    assert all(read(n) is None for n in SETUP)


def test_a_program_without_telemetry_reads_nothing(telemetry, monkeypatch):
    import repro_torch

    _steps(telemetry, [8])
    telemetry.record("pipeline.run", 0, 1000)
    assert read("serve_admit_ms_per_img.open") is not None
    # a program older than the module: nothing to import
    monkeypatch.delattr(repro_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    names = ([b + ".closed" for b in SPAN_METRICS["serve"]] + SPAN_METRICS["resident"] + SETUP)
    assert all(read(n) is None for n in names)


def _mine(name):
    kind = "resident" if name.endswith(".resident") else "serve"
    suffix = "" if kind == "resident" else "." + name.rsplit(".", 1)[1]
    return [m + suffix for m in SPAN_METRICS[kind]] + SETUP


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_tiny_run_lists_and_reads_the_programs_metrics(name, telemetry):
    listed = {m["name"] for m in spec.metrics_for(name, trace=True)}
    assert set(_mine(name)) <= listed
    assert not set(_mine(name)) & {m["name"] for m in spec.metrics_for(name, trace=False)}
    # the tiny window profiles 0.1 s; at the committed 18/s that stretch may
    # hold no arrival, and then no span, so the open loop offers more here
    res = run_tiny(tiny_cell(name, **({"rate_per_s": 200.0} if name.endswith(".open") else {})),
                   trace=True)
    assert res["correct"]
    for m in _mine(name):
        assert res["metrics"][m]["value"] > 0, m
    recorded = {s.name for s in telemetry.spans()}
    assert recorded == ({"pipeline.run"} if name.endswith(".resident") else
                        {"serve.admit", "serve.queued", "serve.step", "serve.stack",
                         "serve.h2d", "pipeline.run", "serve.d2h", "serve.scan"})


@pytest.mark.parametrize("name", CELLS)
def test_an_untraced_run_records_no_span(name, telemetry):
    res = run_tiny(tiny_cell(name), trace=False)
    assert res["correct"] and telemetry.spans() == []
