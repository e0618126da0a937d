"""The port stands alone: nothing under ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package ``repro``,
and importing the port's backend leaves ``jax`` unloaded."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_backend_import_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch.backend, repro_torch.apps, repro_torch.serve, "
        "repro_torch.kernels, repro_torch.kernels.ops, repro_torch.quickstart, "
        "repro_torch.backend.demo, repro_torch.backend.faults, repro_torch.core.simulator, "
        "repro_torch.core.hwmodel, repro_torch.backend.autotune, repro_torch.models, "
        "repro_torch.models.model, repro_torch.configs, repro_torch.train, "
        "repro_torch.train.fault, repro_torch.serve.engine, repro_torch.launch.train, "
        "repro_torch.launch.serve, repro_torch.kernels.grad, repro_torch.distributed, "
        "repro_torch.distributed.ring_attention, repro_torch.distributed.pipeline, "
        "repro_torch.launch.mesh, repro_torch.launch.dryrun, repro_torch.roofline, "
        "repro_torch.roofline.analysis, repro_torch.roofline.dispatch_cost, "
        "repro_torch.roofline.kernel_cost, repro_torch.examples, "
        "repro_torch.examples.serve_demo, repro_torch.examples.train_lm, "
        "repro_torch.examples.schedule_explorer; "
        "from repro_torch.configs import all_configs; all_configs(); "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
