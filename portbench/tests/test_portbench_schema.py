"""The result line: its keys in their order, the metrics the cell names in
``BENCHMARK.json`` with their units, and a CLI that refuses to run without
a CUDA device."""

import json
import subprocess
import sys

import pytest

from portbench import spec

from .conftest import CELLS, ROOT, run_tiny, tiny_cell


def _line(res):
    res = {k: v for k, v in res.items() if not k.startswith("_")}
    return json.loads(json.dumps(res, allow_nan=False))


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_result_line_schema(name, trace):
    cell = tiny_cell(name)
    line = _line(run_tiny(cell, trace=trace))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    want = {m["name"]: m["unit"] for m in spec.metrics_for(name, trace)}
    got = {k: v["unit"] for k, v in line["metrics"].items()}
    # the CPU run reads every metric but those of the device's trace and clock
    device_only = {m["name"] for m in spec.benchmark()["per_layer"]
                   if m["source"] == "device_trace" or m["name"].startswith("serve_host")}
    assert set(got) <= set(want) and set(want) - set(got) <= device_only
    assert all(got[k] == want[k] for k in got)
    assert all(isinstance(v["value"], (int, float)) and v["value"] > 0
               for v in line["metrics"].values())
    assert list(line["checks"]) == ["max_rel_gap", "missing", "compared"]


def test_cli_refuses_without_a_cuda_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and res.stdout == ""
    assert "CUDA device" in res.stderr


def test_cli_refuses_a_cell_benchmark_json_does_not_name():
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "no-such-cell",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
