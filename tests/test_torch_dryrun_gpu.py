"""The dry run's CLI on the card's machine (``gpu``; skipped where no CUDA
device is visible): one reduced cell through ``launch.dryrun.main`` in a
subprocess (its fake world of 256 ranks is that process's own), its fit
test read from the card.  No JAX import: a card test runs where only
PyTorch is installed."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = [pytest.mark.torch, pytest.mark.gpu]

ROOT = Path(__file__).resolve().parents[1]

CLI = """
import sys
import repro_torch.launch.dryrun as dryrun
from repro_torch.configs import get_config
dryrun.get_config = lambda arch: get_config(arch).reduced()
dryrun.RESULTS_DIR = sys.argv[1]
sys.exit(dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "prefill_32k", "--force"]))
"""


def test_dryrun_cli_on_a_reduced_cell_reads_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fit test reads the card's memory")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", CLI, str(tmp_path)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert "prefill_32k  SP OK" in res.stdout
    rep = json.loads((tmp_path / "tinyllama_1_1b__prefill_32k__sp.json").read_text())
    assert rep["status"] == "ok" and rep["chips"] == 256
    assert rep["memory"]["budget_of"] == torch.cuda.get_device_name(0)
    assert rep["memory"]["budget_bytes"] == torch.cuda.get_device_properties(0).total_memory
    # the reduced model's 2 layers, each on the attention kernel's fake
    assert rep["roofline"]["trace_cost"]["kernels"] == {"flash_attention": 2}
    assert rep["roofline"]["flops"] > 0 and rep["memory"]["fits_80gb"]
