#!/usr/bin/env python3
"""Time the serve bridge's non-finite guard on one GPU and its host.

    python3 scripts/finite_guard_probe.py [--reps 64] [--out FILE]

On the host, over a pool of 16 requests taken in turn (so no request is
warm in the CPU's caches), at torch's default thread count, back to back
and each after 5 ms of sleep: the full scan ``np.isfinite(a).all()``,
``np.add.reduce``, ``a.min()`` and ``a.max()``, ``torch.from_numpy(a).sum()``
and the bridge's ``_sum_is_finite``, for a 2048² f32 harris frame and for a
resnet conv2_x request (a 64×58×58 ifmap and the 64×64×3×3 weights).  On
the device, between CUDA events, the exact flag per slot
(``_finite_slots``) of 8 harris outputs of 2044², of one, and of 8 resnet
outputs, beside ``torch.aminmax`` per slot; and, for comparison, the host
scan of 8 harris outputs that the flag replaces.  Prints one JSON line (ms:
a median on the device, a median and a 90th percentile on the host) and,
with ``--out``, writes it there.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

POOL = 16
IDLE_S = 0.005        # a gap between requests: torch's pool threads go to sleep


def host_ms(fn, pool, reps, idle_s=0.0):
    """Median and 90th percentile of the host milliseconds of ``fn(x)``, x
    taken from ``pool`` in turn, each call after ``idle_s`` of sleep."""
    for x in pool:
        fn(x)
    times = []
    for i in range(reps):
        x = pool[i % len(pool)]
        time.sleep(idle_s)
        t = time.perf_counter()
        fn(x)
        times.append(1e3 * (time.perf_counter() - t))
    return [statistics.median(times), statistics.quantiles(times, n=10)[-1]]


def device_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--out")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.backend.serve_bridge import _finite_slots, _sum_is_finite

    if not torch.cuda.is_available():
        print("finite_guard_probe.py: no CUDA device is visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    rng = np.random.default_rng(36)
    harris = [rng.uniform(0, 256, (2048, 2048)).astype(np.float32) for _ in range(POOL)]
    weights = rng.normal(0, 0.0589, (64, 64, 3, 3)).astype(np.float32)
    resnet = [(rng.uniform(0, 1, (64, 58, 58)).astype(np.float32), weights) for _ in range(POOL)]

    def over(check):
        return lambda req: [check(a) for a in req]

    def np_sum(a):
        with np.errstate(over="ignore", invalid="ignore"):
            return np.isfinite(np.add.reduce(a, axis=None))

    checks = {
        "isfinite_all": lambda a: np.isfinite(a).all(),
        "np_add_reduce": np_sum,
        "np_min_max": lambda a: np.isfinite(a.min()) and np.isfinite(a.max()),
        "torch_sum": lambda a: bool(torch.from_numpy(a).sum().isfinite()),
        "sum_is_finite": _sum_is_finite,
    }
    host = {}
    for label, idle_s in (("", 0.0), ("_idle", IDLE_S)):
        host["harris_frame" + label] = {
            k: host_ms(f, harris, args.reps, idle_s) for k, f in checks.items()}
        host["resnet_request" + label] = {
            k: host_ms(over(f), resnet, args.reps, idle_s) for k, f in checks.items()}
    line = {
        "card": card, "torch": torch.__version__, "cpu_count": os.cpu_count(),
        "affinity": len(os.sched_getaffinity(0)), "torch_threads": torch.get_num_threads(),
        "host_ms": host,
    }

    def aminmax_flags(x):
        lo, hi = torch.aminmax(x.flatten(1), dim=1)
        return lo.isfinite() & hi.isfinite()

    outs = torch.rand((8, 2044, 2044), device="cuda")
    conv = torch.rand((8, 64, 56, 56), device="cuda")
    line["device_ms"] = {
        "harris_8_finite_slots": device_ms(lambda: _finite_slots(outs), args.reps),
        "harris_1_finite_slots": device_ms(lambda: _finite_slots(outs[:1]), args.reps),
        "harris_8_aminmax": device_ms(lambda: aminmax_flags(outs), args.reps),
        "harris_1_aminmax": device_ms(lambda: aminmax_flags(outs[:1]), args.reps),
        "resnet_8_finite_slots": device_ms(lambda: _finite_slots(conv), args.reps),
        "resnet_8_aminmax": device_ms(lambda: aminmax_flags(conv), args.reps),
    }
    host_outs = outs.cpu().numpy()
    line["host_ms"]["harris_8_output_scan"] = host_ms(
        lambda a: [np.isfinite(a[b]).all() for b in range(8)], [host_outs], max(8, args.reps // 8)
    )
    text = json.dumps(line)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
