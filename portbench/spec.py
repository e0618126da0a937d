"""Find a cell, its configuration, its traffic mix and its metrics by name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK)


def cell(name: str) -> dict:
    """The cell ``name``: its file under ``workloads/`` with the configuration
    and the traffic mix it names loaded in place of their names.  Raises
    ``ValueError`` where ``BENCHMARK.json`` describes the cell otherwise."""
    c = load_json(HERE / "workloads" / f"{name}.json")
    listed = [w for w in benchmark()["workloads"] if w["name"] == name]
    if not listed:
        raise ValueError(f"BENCHMARK.json has no cell {name!r}")
    for key in ("config", "traffic", "chips", "why"):
        if listed[0][key] != c[key]:
            raise ValueError(f"cell {name!r}: {key} is {c[key]!r} in its file, "
                             f"{listed[0][key]!r} in BENCHMARK.json")
    return dict(c, name=name,
                config=load_json(HERE / "configs" / f"{c['config']}.json"),
                traffic=load_json(HERE / "traffic" / f"{c['traffic']}.json"))


def metrics_for(name: str, trace: bool) -> List[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced.  A metric without a
    ``workloads`` key is every cell's (a per-layer one: every cell that
    reports the end-to-end metric it moves)."""
    b = benchmark()
    e2e = [m for m in b["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in b["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in mine else [])]


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<metric>.py``, or of ``metrics/<base>.py`` where
    ``<base>`` is the name before its first dot: one quantity read in cells
    that report different end-to-end metrics has one reader."""
    for stem in (metric, metric.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                "portbench.metrics." + stem.replace(".", "_").replace("-", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric!r} under {HERE / 'metrics'}")


def peaks() -> dict:
    return load_json(HERE / "peaks.json")
