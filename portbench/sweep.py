"""The knee sweep of an open-loop cell: run its window at each offered rate
in one process (set up once) and print, a line each, the offered rate, the
achieved rate, the 95th percentile latency and whether the backlog grew
(more than two dispatches' worth still queued when the last request
arrived).  The highest rate that keeps up is the knee; the cell's mix
offers a fixed share of it, written into ``traffic/<mix>.json`` as a number.

    python3 portbench/sweep.py --workload harris2048.open --rates 24,28,32,36,40 --seconds 20 --seed 7
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench.run import run_cell, setup_process  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="offered rates, comma-separated, per second")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    setup_process()
    from portbench import spec

    p95 = spec.reader("latency_p95_ms")
    base = spec.cell(args.workload)
    if base["traffic"]["kind"] != "open":
        raise SystemExit(f"{args.workload}: a sweep needs an open-loop cell")
    print("offered_per_s achieved_per_s p95_ms queued_at_close grew correct", flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell["traffic"]["rate_per_s"] = rate
        res = run_cell(cell, args.seed, args.seconds, False)
        rec = res["_record"]
        row = {"offered_per_s": rate, "achieved_per_s": rec["images"] / rec["window_s"],
               "p95_ms": p95(rec), "queued_at_close": rec["backlog_at_close"],
               "grew": rec["backlog_at_close"] > 2 * rec["batch_slots"],
               "correct": res["correct"]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
