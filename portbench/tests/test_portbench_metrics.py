"""Each metric reader on synthetic records, and the reduction of a
profiled stretch on synthetic intervals."""

import math

import pytest

from portbench import spec, tracing

MS = 1_000_000          # ns


def _rec(**kw):
    base = {"setup_s": 7.5, "window_s": 20.0, "images": 400, "batch_slots": 8,
            "floor_s_per_img": 1e-5, "profile": None}
    base.update(kw)
    return base


def read(name, rec):
    return spec.reader(name)(rec)


def test_rates_and_setup():
    served = _rec(latencies_s=[0.1] * 400)
    assert read("img_per_s", served) == 20.0
    assert read("resident_img_per_s", served) is None
    resident = _rec(launch_host_s=[], images=200000)
    assert read("resident_img_per_s", resident) == 10000.0
    assert read("img_per_s", resident) is None
    assert read("setup_s", served) == 7.5


def test_latency_p95_is_the_nearest_rank_over_all_requests():
    lat = [i / 1000 for i in range(1, 101)]          # 1..100 ms
    assert read("latency_p95_ms", _rec(latencies_s=lat)) == pytest.approx(95.0)
    assert read("latency_p95_ms", _rec(latencies_s=lat[::-1])) == pytest.approx(95.0)
    # a failed request counts as missing the limit: six of a hundred push p95 past every time
    failed = lat[:94] + [math.inf] * 6
    assert read("latency_p95_ms", _rec(latencies_s=failed)) is None
    assert read("latency_p95_ms", _rec(latencies_s=[])) is None


def test_serve_host_ms_per_img_and_batch_fill():
    rec = _rec(host_s=10.0, seam_s=0.4, images=480, served=480, dispatches=80)
    assert read("serve_host_ms_per_img.open", rec) == pytest.approx(1e3 * 9.6 / 480)
    assert read("serve_host_ms_per_img.closed", rec) == read("serve_host_ms_per_img.open", rec)
    assert read("batch_fill_pct.open", rec) == pytest.approx(75.0)
    assert read("serve_host_ms_per_img.open", _rec(host_s=1.0, seam_s=None)) is None
    assert read("batch_fill_pct.open", _rec(served=0, dispatches=0)) is None


def test_mfu_and_launch():
    rec = _rec(images=400, window_s=2.0, floor_s_per_img=1e-5)
    assert read("mfu_pct.closed", rec) == pytest.approx(0.2)
    assert read("mfu_pct.resident", rec) == pytest.approx(0.2)
    assert read("launch_host_us.resident", _rec(launch_host_s=[40e-6, 60e-6])) == pytest.approx(50.0)
    assert read("launch_host_us.resident", _rec(launch_host_s=[])) is None


def _profile(device, spans=(), ops=(), t1=10 * MS):
    return tracing.summarize(device, list(spans), list(ops), 0, t1)


def test_summarize_busy_idle_and_gaps():
    dev = [(1 * MS, 3 * MS, "k"), (2 * MS, 4 * MS, "Memcpy HtoD"), (6 * MS, 7 * MS, "k")]
    spans = [(0, 5 * MS, "step"), (5 * MS, 10 * MS, "submit")]
    ops = [(4500 * 1000, 5500 * 1000, "aten::to"), (4500 * 1000, 5 * MS, "aten::copy_")]
    p = _profile(dev, spans, ops)
    assert p["window_s"] == pytest.approx(0.010)
    assert p["busy_s"] == pytest.approx(0.004)
    assert p["device_s"] == pytest.approx({"k": 0.003, "Memcpy HtoD": 0.002})
    gaps = dict(p["idle_gaps"])
    assert gaps == pytest.approx({"step": 0.001, "submit > aten::to": 0.002, "submit": 0.003})
    assert p["idle_gaps"][0][0] == "submit"
    b = tracing.breakdown(p, top=1)
    assert b == {"device_ops": [["k", pytest.approx(0.003)]],
                 "idle_gaps": [["submit", pytest.approx(0.003)]]}


def test_summarize_clips_to_the_stretch():
    p = _profile([(-2 * MS, 1 * MS, "k"), (9 * MS, 12 * MS, "k")])
    assert p["busy_s"] == pytest.approx(0.002)
    assert dict(p["idle_gaps"]) == pytest.approx({"harness": 0.008})


def test_device_idle_and_kernel_roofline():
    prof = _profile([(0, 5 * MS, "void (anonymous namespace)::ub_kernel_0(UbParams0)"),
                     (5 * MS, 6 * MS, "Memcpy DtoH")])
    prof["calls"] = 50
    rec = _rec(profile=prof, floor_s_per_img=1e-5)
    assert read("device_idle_pct.closed", rec) == pytest.approx(40.0)
    assert read("device_idle_pct.resident", rec) == pytest.approx(40.0)
    # 50 dispatches of 8 images at 10 us each against 5 ms of kernel
    assert read("ub_kernel_roofline.resident", rec) == pytest.approx(80.0)
    # a trace that saw no device work, or none of the port's kernels, gives nothing
    empty = _profile([])
    empty["calls"] = 50
    assert read("device_idle_pct.resident", _rec(profile=empty)) is None
    assert read("ub_kernel_roofline.resident", _rec(profile=empty)) is None
    assert read("device_idle_pct.closed", _rec()) is None
    assert read("ub_kernel_roofline.resident", _rec()) is None
