"""Tiny cells for the CPU tests: each real cell with its configuration cut
to the size its file gives under ``tiny`` (app ``kwargs`` and input
shapes), which the CPU runs in a fraction of a second on the plain version
of the port's kernels; everything else as committed."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from portbench import spec, work  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def tiny_cell(name: str, **traffic) -> dict:
    c = spec.cell(name)
    cfg = c["config"]
    tiny = cfg.pop("tiny")
    cfg["kwargs"].update(tiny["kwargs"])
    for n, shape in tiny["inputs"].items():
        cfg["inputs"][n]["shape"] = shape
    cfg["work"] = work.count(cfg)
    c["traffic"].update(traffic)
    return c


def run_tiny(cell: dict, seed: int = 2 ** 31 + 11, seconds: float = 0.4, trace: bool = False,
             controls=()):
    from portbench.run import run_cell

    return run_cell(cell, seed, seconds, trace, device="cpu", kernels="eager", controls=controls)

