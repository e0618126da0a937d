#!/usr/bin/env python3
"""Time thread-map variants of the element-parallel generated groups, and of
mobilenet's group that carries nothing, on one GPU.

    python3 scripts/element_map_probe.py [--apps resnet,matmul,upsample,mobilenet]
        [--batches 8,1] [--variants loop,128x8,128x4,t16,t4] [--out FILE]

For each app at its ``chip_smoke.py`` size and each batch, every variant of
the element-parallel emission (``cuda_codegen.element_map``) or of the
register-tiled output panel (``cuda_codegen.output_tile``) is emitted,
built (one nvcc per variant, all started together), held bit for bit
against the plain PyTorch version on the same CUDA inputs, and timed: one
call between CUDA events (median of 10) and per call over replays of a
CUDA graph behind an L2-evicting write (``chip_smoke.graph_ms``).  A
variant is ``<threads>x<tile>`` (the most threads per block, the most
elements of the tile axis one thread evaluates together), optionally
followed by ``b<blocks>`` (the cap on blocks per slot), ``u<n>`` (the
unroll of a rolled run of reduction terms), ``r<n>`` (the shortest run
rolled), ``R<n>`` (the longest run of thread-axis positions a thread,
``RUN_MAX``), ``F<n>`` (the blocks an SM the launch aims at,
``FILL_BLOCKS``) and ``S<n>`` (KiB a block may stage, ``TILED_SMEM_MAX``;
``S0`` stages nothing); or ``t<n>``, the most
output elements a thread of mobilenet's tiled output panel evaluates
(``OUT_TILE_MAX``); or ``loop``: the element loop every carried or fused
group uses, which these groups took before their own thread map (for
mobilenet also with no input staged).  Prints one line per variant (with
its registers and spills from ``ptxas -v`` and its nvcc seconds) and, with
``--out``, writes them as JSON.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
APPS = {
    "resnet": ({"img": 56, "cin": 64, "cout": 64}, True),
    "matmul": ({"m": 256, "n": 256, "k": 1000}, True),
    "upsample": ({"size": 1024}, False),
    "mobilenet": ({"img": 112, "cin": 32, "cout": 64}, True),
}


def emit(app, batch: int, variant: str):
    """The variant's lowered groups and library source."""
    from repro_torch.backend import cuda_codegen as cc
    from repro_torch.backend.eager import LoweredGroup
    from repro_torch.backend.plan import build_pipeline_plan
    from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK

    kw = {"batch": batch, "batch_capacity": batch} if batch > 1 else {}
    plan = build_pipeline_plan(app.pipeline, vmem_budget=H100_SMEM_PER_BLOCK, **kw)
    lowered = [LoweredGroup(kg) for kg in plan.kernels]
    knobs = ("THREADS_ELEMENT", "TILE_MAX", "MAX_BLOCKS_PER_SLOT", "ROLL_UNROLL", "ROLL_MIN",
             "RUN_MAX", "FILL_BLOCKS", "TILED_SMEM_MAX",
             "element_map", "output_tile", "staged_inputs", "OUT_TILE_MAX")
    saved = {k: getattr(cc, k) for k in knobs}
    try:
        tiled = re.fullmatch(r"t(\d+)", variant)
        if variant == "loop":
            cc.element_map = lambda lg: None
            cc.output_tile = lambda lg: None
            cc.staged_inputs = lambda lg: []
        elif tiled:
            cc.OUT_TILE_MAX = int(tiled.group(1))
        else:
            m = re.fullmatch(r"(\d+)x(\d+)(?:b(\d+))?(?:u(\d+))?(?:r(\d+))?(?:R(\d+))?"
                             r"(?:F(\d+))?(?:S(\d+))?", variant)
            if m is None:
                raise SystemExit(f"bad variant {variant!r}")
            for k, v in zip(knobs, m.groups()):
                if v:
                    setattr(cc, k, int(v) * (1024 if k == "TILED_SMEM_MAX" else 1))
        maps = [(cc.element_map(lg), cc.output_tile(lg), cc.staged_inputs(lg)) for lg in lowered]
        return lowered, maps, cc.emit_library(lowered)
    finally:
        for k, v in saved.items():
            setattr(cc, k, v)


def back_to_back_ms(fn, reps: int = 100) -> float:
    """Milliseconds a call of ``fn`` over ``reps`` calls launched back to
    back between two CUDA events, as a resident batch stream runs them."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--apps", default="resnet,matmul,upsample")
    ap.add_argument("--batches", default="8,1")
    ap.add_argument("--variants", default="loop,128x8")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("element_map_probe.py: no CUDA device is visible", file=sys.stderr)
        return 2
    from chip_smoke import card_line, graph_ms, inputs_for, time_ms
    from repro_torch.apps import make_app
    from repro_torch.backend.build import build_many, digest, load_library, ptxas_usage
    from repro_torch.backend.cuda_codegen import CudaKernel
    from repro_torch.backend.eager import EagerKernel

    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    jobs = []
    for name in args.apps.split(","):
        kw, integer = APPS[name]
        app = make_app(name, **kw)
        for batch in map(int, args.batches.split(",")):
            for variant in args.variants.split(","):
                jobs.append((name, app, integer, batch, variant, *emit(app, batch, variant)))
    t0 = time.perf_counter()
    secs = build_many([job[-1] for job in jobs])
    print(f"[build] {len(secs)} builds, wall {time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    rng = np.random.default_rng(20261017)
    plain_cache = {}
    for name, app, integer, batch, variant, lowered, maps, src in jobs:
        (lg,), ((em, ot, staged),) = lowered, maps
        key = (name, batch)
        if key not in plain_cache:
            ins = inputs_for(app, rng, batch=batch if batch > 1 else None, integer=integer)
            bufs = {n: torch.from_numpy(a).cuda() for n, a in ins.items()}
            plain_cache[key] = (bufs, EagerKernel(lg)(bufs))
        bufs, want = plain_cache[key]
        k = CudaKernel(lg, load_library(src), "0")
        got = k(bufs)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        usage = ptxas_usage(src).get("ub_kernel_0", {})
        row = {
            "app": name, "batch": batch, "variant": variant,
            "thread_axis": em.thread_axis if em else None,
            "tile": em.tile if em else None, "threads": em.threads if em else None,
            "run": em.run if em else None, "chunks": em.chunks if em else None,
            "staged_bytes": sum(st.nbytes for st in em.staged) if em else None,
            "blocks": (em.blocks if em else None), "bit_equal": bool(same),
            "output_tile": [ot.rows, ot.cols] if ot else None,
            "staged": [[st.buffer, st.smem_bytes] for st in staged],
            "blocks_per_sm": k.blocks_per_sm(),
            "ms": time_ms(lambda: k(bufs), 10), "graph_ms": graph_ms(lambda: k(bufs)),
            "back_to_back_ms": back_to_back_ms(lambda: k(bufs)),
            "nvcc_s": secs.get(digest(src)), **usage, "card": card,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not same:
            print(f"[probe] {name} b{batch} {variant}: differs from the plain version",
                  flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0 if all(r["bit_equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
