"""End-to-end backend demo: plan and compile the paper apps to the port's
kernels, run them and validate.

    PYTHONPATH=src python -m repro_torch.backend.demo [--apps a,b,c] [--smoke]
        [--no-fuse] [--verify] [--device {cuda,cpu}] [--kernels {cuda,eager}]

The counterpart of the JAX package's ``backend/demo.py``.  The default runs
each app's generated CUDA kernels on the card (``--device cuda --kernels
cuda``); ``--device cpu`` runs their plain PyTorch versions
(``kernels="eager"``) on the CPU, and ``--kernels eager`` runs the plain
versions on the card.  With no visible GPU the default raises: nothing
falls back to the CPU.

For each app: lower -> plan (fusion, grid reductions, line buffers, at the
H100's shared memory per block) -> one kernel per planned group, run twice
on seeded integer inputs (``run_us_cold`` is the first run, the one that
records the eval sites; ``run_us_warm`` the second), and every
materialized buffer compared with the reference interpreter within ``TOL``
(``matmul_bigk`` with a dense f64 product, and it must carry its reduction
in a grid).  The plan shape must match the golden tables (``golden.py``):
multi-stage apps stay fused and keep their line-buffer decisions against a
``line_buffer=False`` twin planned on the same budget, and every plan passes
the static verifier.  An identical re-compile must hit the plan cache.
``smem_kib`` is the kernels' shared memory (``cuda_codegen.shared_bytes``).
Exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.apps import make_app
from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK

from . import golden
from .cuda_codegen import shared_bytes
from .plan import build_pipeline_plan
from .runner import (
    clear_pipeline_cache,
    compile_pipeline,
    max_abs_error,
    pipeline_cache_stats,
    resolve_device,
)

# tolerance for the f64 reference vs the f32 kernels; stencil/DNN integer
# inputs are exact, division chains (harris response) accumulate ~1e-4
TOL = 1e-3

DEMO_APPS: List[Tuple[str, Dict]] = [
    ("gaussian", {}),
    ("harris", {"schedule": "sch3", "size": 20}),
    ("upsample", {"size": 16}),
    ("unsharp", {"size": 18}),
    # size 16 pins the strided-ring arbitration (GOLDEN_LINEBUF)
    ("camera", {"size": 16}),
    ("resnet", {"img": 8, "cin": 4, "cout": 4}),
    ("mobilenet", {"img": 8, "cin": 4, "cout": 4}),
    ("matmul", {"m": 32, "n": 32, "k": 16}),
    ("matmul_bigk", {"m": 16, "n": 16, "k": 2048}),
]

SMOKE_APPS = ["gaussian", "unsharp", "matmul", "matmul_bigk"]


def make_demo_app(name: str, kw: Dict):
    """The app a ``DEMO_APPS`` row names (``matmul_bigk`` is a matmul)."""
    return make_app("matmul" if name == "matmul_bigk" else name, **kw)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_demo(
    app_names=None, smoke: bool = False, fuse: bool = True,
    device: str = "cuda", kernels: Optional[str] = None, verify: bool = False,
) -> List[Dict]:
    """One row per app (see the module docstring); ``kernels`` defaults to
    ``"cuda"`` on the card and ``"eager"`` on the CPU."""
    dev = resolve_device(device)
    if kernels is None:
        kernels = "cuda" if dev.type == "cuda" else "eager"
    # reset_stats: the footer main() prints reports only this run's traffic
    clear_pipeline_cache(reset_stats=True)
    wanted = set(app_names) if app_names else None
    if wanted is not None:
        known = {name for name, _ in DEMO_APPS}
        unknown = wanted - known
        if unknown:
            raise SystemExit(f"unknown app(s) {sorted(unknown)}; choose from {sorted(known)}")
    if smoke and wanted is None:
        wanted = set(SMOKE_APPS)
    ckw = dict(fuse=fuse, device=dev, kernels=kernels, verify=False, cache=True)
    rows: List[Dict] = []
    for name, kw in DEMO_APPS:
        if wanted is not None and name not in wanted:
            continue
        app = make_demo_app(name, kw)
        plan_us = None
        if verify:
            # cold plan wall-clock without certification, so the verifier's
            # share below is an honest ratio
            t0 = time.perf_counter()
            build_pipeline_plan(app.pipeline, fuse=fuse, vmem_budget=H100_SMEM_PER_BLOCK)
            plan_us = (time.perf_counter() - t0) * 1e6
        t0 = time.perf_counter()
        # verify=False: certification is reported as plan notes below (a
        # MISMATCH row and exit 1) instead of a traceback mid-table
        pp = compile_pipeline(app.pipeline, **ckw)
        compile_us = (time.perf_counter() - t0) * 1e6
        t0 = time.perf_counter()
        verify_notes = golden.check_plan_verified(name, pp.plan)
        verify_us = (time.perf_counter() - t0) * 1e6
        rng = np.random.default_rng(0)
        inputs = {
            n: rng.integers(0, 16, s).astype(np.float32)
            for n, s in app.input_extents.items()
        }
        _sync(dev)
        t0 = time.perf_counter()
        got = pp.run(inputs)
        _sync(dev)
        cold_us = (time.perf_counter() - t0) * 1e6
        t0 = time.perf_counter()
        warm = pp.run(inputs)
        _sync(dev)
        warm_us = (time.perf_counter() - t0) * 1e6
        out = got[pp.pipeline.output].cpu().numpy()
        if not np.array_equal(out, warm[pp.pipeline.output].cpu().numpy()):
            verify_notes = verify_notes + ["a warm run differs from the cold run"]

        plan_notes: List[str] = list(verify_notes)
        if compile_pipeline(app.pipeline, **ckw) is not pp:
            plan_notes.append("identical re-compile missed the pipeline cache")
        if name == "matmul_bigk":
            # the reference interpreter is too slow at K=2048; the dense
            # f64 product is the same golden value
            a, b = inputs["A"].astype(np.float64), inputs["B"].astype(np.float64)
            err = float(np.max(np.abs(out - a @ b)))
            ck = pp.kernels[0]
            if fuse and (ck.red_grid is None or len(ck.grid) != 2):
                plan_notes.append("expected grid-level reduction for K=2048")
        else:
            err = max(max_abs_error(pp, inputs, got=got).values())
        expected = golden.expected_plan_shape(name, kw.get("schedule")) if fuse else None
        if expected is not None:
            want_stages, want_kernels = expected
            if (pp.plan.n_stages, pp.plan.n_kernels) != (want_stages, want_kernels):
                plan_notes.append(
                    f"plan regressed vs golden table: expected {want_stages} "
                    f"stages in {want_kernels} kernels, got {pp.plan.n_stages} "
                    f"in {pp.plan.n_kernels}"
                )
        # carry contract: the line-buffer decisions against a recompute twin
        # planned on the same budget as the plan itself
        if fuse and golden.expected_linebuf(name, kw.get("schedule")) is not None:
            plan_rc = build_pipeline_plan(
                app.pipeline, line_buffer=False, vmem_budget=H100_SMEM_PER_BLOCK
            )
            plan_notes.extend(
                golden.check_linebuf_plan(name, kw.get("schedule"), pp.plan, plan_rc)
            )
        lb_stages = sorted(n for names in pp.plan.line_buffered.values() for n in names)
        rows.append({
            "app": name,
            "stages": pp.plan.n_stages,
            "kernels": pp.plan.n_kernels,
            "grids": {ck.name: list(ck.grid) for ck in pp.kernels},
            "streams": sum(len(ck.groups) + 1 for ck in pp.kernels),
            "linebuf": "+".join(lb_stages) if lb_stages else "-",
            "rings": pp.plan.n_rings,
            "eval_rows": pp.plan.total_eval_rows(),
            "smem_kib": sum(shared_bytes(ck.lg) for ck in pp.kernels) / 1024,
            "hbm_kib": pp.plan.hbm_bytes() // 1024,
            "compile_us": round(compile_us),
            "run_us_cold": round(cold_us),
            "run_us_warm": round(warm_us),
            "launches": {ck.name: getattr(ck, "launches", None) for ck in pp.kernels},
            "max_err": err,
            "verified": "yes" if not verify_notes else "FAIL",
            "verify_us": round(verify_us),
            "plan_us": round(plan_us) if plan_us is not None else None,
            "plan_notes": plan_notes,
            "ok": err <= TOL and not plan_notes,
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--apps", help="comma-separated app subset")
    ap.add_argument("--smoke", action="store_true", help="fast 4-app subset")
    ap.add_argument("--no-fuse", action="store_true",
                    help="per-stage compilation (skips the plan-shape assertions)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the kernels run (default: the card)")
    ap.add_argument("--kernels", choices=["cuda", "eager"],
                    help="the generated CUDA kernels or their plain versions "
                         "(default: cuda on the card, eager on the CPU)")
    ap.add_argument("--verify", action="store_true",
                    help="also report the static verifier's share of cold plan "
                         "wall-clock (every plan is certified either way)")
    args = ap.parse_args(argv)
    names = args.apps.split(",") if args.apps else None
    rows = run_demo(names, smoke=args.smoke, fuse=not args.no_fuse,
                    device=args.device, kernels=args.kernels, verify=args.verify)
    print("app,stages,kernels,streams,linebuf,rings,eval_rows,smem_kib,"
          "hbm_kib,compile_us,run_us_cold,run_us_warm,max_err,verified,status")
    ok = True
    for r in rows:
        status = "OK" if r["ok"] else "MISMATCH"
        ok = ok and r["ok"]
        print(f"{r['app']},{r['stages']},{r['kernels']},{r['streams']},"
              f"{r['linebuf']},{r['rings']},{r['eval_rows']},"
              f"{r['smem_kib']:.1f},{r['hbm_kib']},{r['compile_us']},"
              f"{r['run_us_cold']},{r['run_us_warm']},{r['max_err']:.2e},"
              f"{r['verified']},{status}")
        for note in r["plan_notes"]:
            print(f"#   {r['app']}: {note}", file=sys.stderr)
    cs = pipeline_cache_stats()
    print(f"# pipeline cache: {cs['misses']} cold compiles, {cs['hits']} hits, "
          f"{cs['evictions']} evictions, {cs['entries']} entries", file=sys.stderr)
    if args.verify:
        plan_us = sum(r["plan_us"] for r in rows)
        verify_us = sum(r["verify_us"] for r in rows)
        pct = 100.0 * verify_us / max(plan_us, 1.0)
        print(f"# verify: {verify_us / 1e3:.1f}ms over {plan_us / 1e3:.1f}ms "
              f"cold plan wall-clock ({pct:.1f}% overhead)", file=sys.stderr)
    if not ok:
        print("backend demo: MISMATCH against reference/plan", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
