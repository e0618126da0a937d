"""The readings that a cell's limit on ``max_rel_gap`` is set from, on the
card at the cell's own size: the program's gap on each seed (a short window
at the cell's load, its sample compared as a run compares it) and, on the
same sampled inputs, the gap of each control: the plain reference computed
in the configuration's lower precision and put in the program's place.  One process, set up
once.  The lower reading is the largest program gap, the upper the
smallest control gap; the limit lies between (see PERF.md).

    python3 portbench/calibrate.py --workload resnet18-conv2x.closed --seeds 1,2,3 --seconds 4
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench.run import run_cell, setup_process  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    setup_process()
    from portbench import spec

    cell = spec.cell(args.workload)
    controls = [cell["config"]["control"]]
    gaps, ctl = [], {c: [] for c in controls}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(cell, seed, args.seconds, False, controls=controls)
        gap = res["checks"]["max_rel_gap"]["value"]
        gaps.append(gap)
        for c in controls:
            ctl[c].append(res["_controls"][c])
        print(json.dumps({"seed": seed, "program": gap, "missing": res["failed"],
                          "compared": res["checks"]["compared"]["value"], **res["_controls"]}),
              flush=True)
    print(json.dumps({"workload": args.workload, "lower": max(g if g is not None else float("inf")
                                                             for g in gaps),
                      "upper": {c: min(v) for c, v in ctl.items()},
                      "limit": cell["check"]["max_rel_gap"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
