"""What a run may load: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the JAX package; ``repro_torch``, the
port, passes), compared by whole top-level names.  Here every harness
module and what a run imports of the port, in a fresh process; on the card
a whole short run.  And nothing of the harness names the JAX package's
benchmark files or the port's smoke script."""

import json
import subprocess
import sys

import pytest

from portbench import spec

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in spec.HERE.rglob("*.py")
    if "tests" not in p.parts and "metrics" not in p.parts and p.stem not in ("run", "sweep", "calibrate")
)

PROBE = """
import importlib, json, sys
sys.path[:0] = [{root!r}, {src!r}]
for m in {modules!r}:
    importlib.import_module(m)
from portbench import spec
for m in spec.benchmark()["end_to_end"] + spec.benchmark()["per_layer"]:
    spec.reader(m["name"])
import repro_torch.apps, repro_torch.backend  # what the generators load of the port
import portbench.run
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""


def test_harness_modules_load_no_jax():
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), modules=MODULES)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd="/")
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "portbench" in loaded and "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert not {"repro_torch_extra", "jaxtyping"} & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in run.forbidden_modules()


def test_harness_reads_no_file_of_the_jax_benchmark_or_the_smoke_script():
    for path in spec.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for name in ("chip_smoke", "BENCH_backend", "benchmarks/", "benchmarks."):
            assert name not in text, (path, name)


@pytest.mark.gpu
def test_a_short_run_on_the_card_loads_no_jax():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "resnet18-conv2x.resident",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
