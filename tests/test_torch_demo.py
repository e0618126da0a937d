"""The port's backend demo (``python -m repro_torch.backend.demo``).

On the CPU the smoke subset runs the plain versions of the generated
kernels (``--device cpu``) and must exit 0: every buffer within ``TOL`` of
the reference interpreter, golden plan shapes and line-buffer decisions,
the plan cache hit on an identical re-compile, ``matmul_bigk`` against a
dense f64 product with its grid reduction.  A broken golden table must make
it exit non-zero, and the default device, the card, must raise where no
GPU is visible.  The ``gpu`` case runs every demo app's CUDA kernels.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.backend import demo, golden

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.backend.demo", *args],
        env=env, capture_output=True, text=True, timeout=300,
    )


def test_smoke_verify_on_cpu_exits_zero():
    res = _run("--smoke", "--verify", "--device", "cpu")
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].split(",")[7] == "smem_kib" and lines[0].split(",")[10] == "run_us_cold"
    rows = {line.split(",")[0]: line for line in lines[1:]}
    assert set(rows) == set(demo.SMOKE_APPS)
    assert all(line.endswith(",yes,OK") for line in rows.values())
    assert "4 cold compiles, 4 hits" in res.stderr and "# verify:" in res.stderr


def test_broken_golden_shape_exits_nonzero(monkeypatch, capsys):
    """A seeded break of the golden table (unsharp promised in two kernels)
    makes the demo report a MISMATCH and exit 1."""
    monkeypatch.setitem(golden.GOLDEN_PLAN_SHAPES, ("unsharp", None), (4, 2))
    assert demo.main(["--apps", "unsharp,gaussian", "--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    rows = {line.split(",")[0]: line for line in out.strip().splitlines()[1:]}
    assert rows["unsharp"].startswith("unsharp,4,1,") and rows["unsharp"].endswith("MISMATCH")
    assert rows["gaussian"].endswith(",yes,OK")
    assert "plan regressed vs golden table" in err


def test_unknown_app_and_missing_card():
    with pytest.raises(SystemExit, match="unknown app"):
        demo.run_demo(["sobel"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            demo.main(["--smoke"])


@pytest.mark.gpu
def test_demo_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    rows = demo.run_demo()
    assert [r["app"] for r in rows] == [name for name, _ in demo.DEMO_APPS]
    for r in rows:
        assert r["ok"], (r["app"], r["max_err"], r["plan_notes"])
        assert all(n >= 2 for n in r["launches"].values()), r["launches"]
