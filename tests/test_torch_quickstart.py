"""The port's quickstart (``python -m repro_torch.quickstart``).

On the CPU (``--device cpu``) it runs steps 1-4 on the port's copies of
the paper's core and step 5 on the stencil's plain version, and must exit 0
with the paper's cycle counts and the mapping the JAX quickstart prints;
its default device, the card, must raise where no GPU is visible.  The
``gpu`` case runs the CUDA kernel and holds it bit for bit against its
plain version.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import quickstart
from repro_torch.kernels import KERNELS

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_on_cpu_exits_zero():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.quickstart", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "policy=stencil  completion=4102 cycles" in out
    assert "mapped input: 7 SR taps, 1 MEM tile(s), 131 SRAM words" in out
    assert "simulation vs reference: OK" in out
    assert "device cpu: step 5 runs the plain PyTorch version" in out
    assert "'threads': 32" in out and "'blocks': 16" in out


def test_quickstart_results_and_missing_card():
    lines = []
    res = quickstart.run("cpu", out=lines.append)
    assert res["problems"] == [] and res["kernels"] == "eager"
    assert (res["completion"], res["plain_err"]) == (4102, 0.0)
    assert res["oracle_err"] <= quickstart.ORACLE_TOL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            quickstart.main([])


@pytest.mark.gpu
def test_quickstart_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    before = KERNELS["stencil3x3"].launches
    res = quickstart.run("cuda", out=lambda s: None)
    assert res["problems"] == [] and res["kernels"] == "cuda"
    assert res["plain_err"] == 0.0
    assert KERNELS["stencil3x3"].launches == before + 1
