"""Schedule autotuner CLI (and the paper §VI-C Table V comparison) — the
port of the JAX package's ``examples/schedule_explorer.py``, line for line.

Default mode runs the verifier-gated autotuner (``backend/autotune``) over
a set of apps: enumerate candidate schedules — joint (bh, bw) pairs,
fusion cut, line-buffer mode, reduction chunk — prune with the scheduler
cycle model, certify every survivor with ``verify_plan`` before it is
emitted or measured, time the certified survivors on the card (the
generated kernel, by CUDA events), and persist each winner in the port's
JSON schedule database (``schedule_db_torch.json``, never the JAX
``schedule_db.json``) that ``compile_pipeline(tune="auto")`` consults.

    PYTHONPATH=src python -m repro_torch.examples.schedule_explorer
    PYTHONPATH=src python -m repro_torch.examples.schedule_explorer \\
        --apps harris,unsharp,matmul --db build/db.json
    PYTHONPATH=src python -m repro_torch.examples.schedule_explorer --no-measure
    PYTHONPATH=src python -m repro_torch.examples.schedule_explorer --table-v
    PYTHONPATH=src python -m repro_torch.examples.schedule_explorer --device cpu --kernels eager

``--table-v`` prints the original paper Table V exploration (throughput /
PE / MEM trade-offs on harris driven purely by scheduling directives),
from the port's copies of the paper's core (``repro_torch.core``).
``--no-measure`` is the model-only search: nothing runs, on no device.
``--device cpu --kernels eager`` times the plain version on the host clock.
The plans fit the H100's shared memory a block, where the JAX script's fit
the TPU's VMEM.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.launch.train import check_route
from repro_torch.models.model import KERNEL_CHOICES

# the autotunable app set: (name, make_app kwargs, case label)
TUNE_APPS = {
    "harris": ({"schedule": "sch3", "size": 20}, "20x20"),
    "unsharp": ({"size": 18}, "18x18"),
    "matmul": ({"m": 16, "n": 16, "k": 2048}, "16x16x2048"),
    "gaussian": ({"size": 18}, "18x18"),
    "camera": ({"size": 16}, "16x16"),
}

DESCRIPTIONS = {
    "sch1": "recompute all intermediates (everything inlined)",
    "sch2": "recompute some (buffer the gradients only)",
    "sch3": "no recompute (buffer every stage)",
    "sch4": "unroll by 2 (two output pixels per cycle)",
    "sch5": "2x larger tile in each dimension",
    "sch6": "last stage on the host CPU",
}


def table_v() -> List[Dict[str, object]]:
    """The paper Table V comparison this script originally printed;
    returns its rows."""
    from repro_torch.apps import make_app
    from repro_torch.core.extraction import extract_buffers
    from repro_torch.core.mapping import map_design
    from repro_torch.core.scheduling import schedule_pipeline

    print(f"{'schedule':8s} {'pixels/cyc':>10s} {'PEs':>6s} {'MEMs':>5s} "
          f"{'cycles':>7s}  description")
    rows = []
    for sch in ["sch1", "sch2", "sch3", "sch4", "sch5", "sch6"]:
        app = make_app("harris", schedule=sch)
        s = schedule_pipeline(app.pipeline)
        ex = extract_buffers(app.pipeline, s)
        mapped = map_design(ex.buffers)
        mems = sum(m.mem_tiles for m in mapped.values())
        px = 2 if sch == "sch4" else 1
        rows.append({"schedule": sch, "pixels_per_cycle": px, "pes": ex.total_pe_ops(),
                     "mems": mems, "cycles": s.completion})
        print(f"{sch:8s} {px:>10d} {ex.total_pe_ops():>6d} {mems:>5d} "
              f"{s.completion:>7d}  {DESCRIPTIONS[sch]}")
    print("\n(compare paper Table V: the same trade-offs, driven purely by "
          "scheduling directives)")
    return rows


def tune(args) -> Dict[str, object]:
    """The searches of ``args`` (``parser()``'s); returns ``rc`` (1 when a
    stored winner measured slower than the heuristic), each app's
    ``TuneResult`` and the db path."""
    from repro_torch.apps import make_app
    from repro_torch.backend.autotune import default_db_path, search

    names = args.apps.split(",")
    unknown = sorted(set(names) - set(TUNE_APPS))
    if unknown:
        raise SystemExit(
            f"unknown app(s) {unknown}; choose from {sorted(TUNE_APPS)}"
        )
    db = None if args.no_db else (args.db or default_db_path())
    print(
        f"{'app':10s} {'case':>12s} {'cands':>5s} {'meas':>4s} {'rej':>3s} "
        f"{'heur_us':>9s} {'tuned_us':>9s} {'speedup':>7s}  winning schedule"
    )
    ok = True
    results = {}
    for name in names:
        kw, case = TUNE_APPS[name]
        app = make_app(name, **kw)
        r = search(
            app.pipeline, label=name, db=db, device=args.device, kernels=args.kernels,
            max_candidates=args.max_candidates, measure_top=args.top,
            measure=not args.no_measure, reps=args.reps, seed=args.seed,
            log=(lambda m: print(f"# {m}", file=sys.stderr)) if args.verbose else None,
        )
        results[name] = r
        sched = json.dumps(r.schedule) if r.schedule else "{} (heuristic)"
        if args.no_measure:
            print(f"{name:10s} {case:>12s} {len(r.candidates):>5d} "
                  f"{'-':>4s} {len(r.rejected):>3d} {'-':>9s} {'-':>9s} "
                  f"{'-':>7s}  {sched} "
                  f"(model: {r.model_cycles and round(r.model_cycles)} vs "
                  f"{r.heuristic_model_cycles and round(r.heuristic_model_cycles)} cyc)")
            continue
        if r.warm_us > r.heuristic_warm_us:
            ok = False                  # structurally impossible; fail loudly
        print(f"{name:10s} {case:>12s} {len(r.candidates):>5d} "
              f"{len(r.measured):>4d} {len(r.rejected):>3d} "
              f"{r.heuristic_warm_us:>9.1f} {r.warm_us:>9.1f} "
              f"{r.speedup:>6.2f}x  {sched}")
    if db is not None:
        print(f"# schedule db: {db}", file=sys.stderr)
    if not ok:
        print("schedule_explorer: a stored winner measured slower than the "
              "heuristic plan (should be structurally impossible — the "
              "heuristic is always a measured candidate)", file=sys.stderr)
    return {"rc": 0 if ok else 1, "results": results, "db": db}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--table-v", action="store_true",
                    help="print the paper Table V scheduling comparison")
    ap.add_argument("--apps", default="harris,unsharp,matmul",
                    help=f"comma-separated subset of {sorted(TUNE_APPS)}")
    ap.add_argument("--db", default=None,
                    help="schedule db path (default: the port's schedule_db_torch.json, "
                         "autotune.default_db_path())")
    ap.add_argument("--no-db", action="store_true",
                    help="search without persisting winners")
    ap.add_argument("--no-measure", action="store_true",
                    help="model-only search (deterministic; nothing executed)")
    ap.add_argument("--max-candidates", type=int, default=32)
    ap.add_argument("--top", type=int, default=8,
                    help="certified candidates to measure per app")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true",
                    help="log pruned/rejected candidates to stderr")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--kernels", choices=KERNEL_CHOICES, default="cuda")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Runs the CLI on ``argv`` (``sys.argv[1:]`` by default); returns
    ``rc`` (the exit code) with ``table_v``'s rows or ``tune``'s results."""
    args = parser().parse_args(argv)
    check_route(args.device, args.kernels)
    if args.table_v:
        return {"rc": 0, "table": table_v()}
    return tune(args)


if __name__ == "__main__":
    sys.exit(main()["rc"])
