"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics (a profiled
stretch of the window).  After the window the outputs of a sample of its
work are compared with the plain reference; the numbers compared are the
last lines on standard error and the result line's last key, ``checks``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``checks``.  Exit 2, with no result, without a CUDA
device or with fewer than the cell asks for; exit 3, with no result, if
JAX, its libraries or the JAX package were loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
PROFILED_S = 5.0          # the longest profiled stretch of a traced run


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *, t_start: float = None,
             device: str = "cuda", kernels: str = "cuda", controls=()) -> dict:
    """One run of ``cell`` (as ``spec.cell`` loads it): set-up, the window,
    then the comparison.  Returns the result line as a dict, and under
    ``"_record"`` what the window recorded, under ``"_controls"`` the gap
    of each precision in ``controls`` put in the program's place."""
    import torch

    from portbench import check, reference, spec, tracing, work
    from portbench.harness import Run, clock

    t_start = clock() if t_start is None else t_start
    tracer = (tracing.Stretch(0.375 * seconds, min(0.25 * seconds, PROFILED_S), device == "cuda")
              if trace else tracing.Off())
    run = Run(cell, seed, seconds, t_start, device, kernels, tracer)
    run.mark("imports")
    rec = importlib.import_module(f"portbench.traffic.{cell['traffic']['kind']}").drive(run)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    rec.update(batch_slots=run.slots, profile=tracer.result(),
               floor_s_per_img=work.floor_s_per_img(run.config, spec.peaks()))
    metrics = {}
    for m in spec.metrics_for(cell["name"], trace):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    rec.pop("close")()
    ref = reference.get(run.config["app"])
    gap, compared = check.max_rel_gap(rec["items"], rec["inputs_of"], ref, device)
    correct, checks = check.checks(gap, cell["check"]["max_rel_gap"], rec["missing"], compared)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["missing"],
              "metrics": metrics, "device": dev}
    if rec["profile"] is not None:
        dev.update(busy_s=rec["profile"]["busy_s"], window_s=rec["profile"]["window_s"])
        result["breakdown"] = tracing.breakdown(rec["profile"])
    result["checks"] = checks
    result["_controls"] = {c: check.max_rel_gap(rec["items"], rec["inputs_of"], ref, device,
                                                control=c)[0] for c in controls}
    rec["marks"] = run.marks
    result["_record"] = rec
    return result


def forbidden_modules() -> list:
    """Top-level names of loaded modules that this process may not hold."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def setup_process() -> None:
    """Paths and caches of a process started as a script of this folder."""
    # the checkout's root, not this folder, heads the path: no module here
    # may shadow another of the same name
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    # the program's kernel caches at fixed paths inside the checkout (its
    # nvcc libraries go to build/torch_kernels/ beside these)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}: the benchmark may load "
              f"neither JAX nor the JAX package", file=sys.stderr)
        return 3
    rec = result.pop("_record")
    result.pop("_controls")
    log = sys.stderr
    print(f"card: {card_line()}", file=log)
    steps, t = [], T_START
    for step, end in rec["marks"]:
        steps.append(f"{step} {end - t:.3f} s")
        t = end
    print("set-up: " + ", ".join(steps), file=log)
    if rec.get("lateness_s"):
        late = sorted(rec["lateness_s"])
        print(f"generator lateness: median {1e3 * late[len(late) // 2]:.3f} ms, "
              f"p95 {1e3 * late[int(0.95 * (len(late) - 1))]:.3f} ms, "
              f"max {1e3 * late[-1]:.3f} ms over {len(late)} requests", file=log)
    if "backlog_at_close" in rec:
        print(f"offered {rec['offered']} requests; {rec['backlog_at_close']} queued when "
              f"the last arrived; {rec['dispatches']} dispatches", file=log)
    for name, c in result["checks"].items():
        bound = f"max {c['max']}" if "max" in c else f"min {c['min']}"
        print(f"check {name}: {c['value']} ({bound})", file=log)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    setup_process()
    sys.exit(main())
