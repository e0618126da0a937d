#!/usr/bin/env python3
"""Time designs of the hand-written 3×3 stencil, and its wrapper's host
work, on one GPU.

    python3 scripts/stencil_probe.py [--size 1080,1920] [--dtypes f32,bf16]
        [--variants plan,regs160x8] [--baseline FILE.cu] [--host 200]
        [--out FILE]

Each variant is built (one nvcc per source, all started together), held
bit for bit against ``stencil3x3_plain`` on the same CUDA inputs (integers
in [0, 256), the gaussian's weights / 16, as ``chip_smoke.py`` phase 7),
and timed: one launch between CUDA events (median of 10) and per launch
over replays of a CUDA graph behind an L2-evicting write
(``chip_smoke.graph_ms``).  Variants:

- ``plan``: the shipped kernel (``csrc/stencil3x3.cu``) as
  ``stencil.plan`` launches it;
- ``regs<threads>x<R>``: the shipped kernel launched with ``threads`` a
  block, every input row of a band in registers before its first sum, its
  source built with bands of ``R`` rows (``ROWS``) where ``R`` is not the
  shipped 4;
- ``clone``: ``x.clone()``, which reads and writes as many bytes as the
  stencil (not checked): the floor of this timing for those bytes;
- with ``--baseline FILE.cu``, ``base``: another source with the C entry
  ``stencil3x3_launch(x, w, out, h, w, dtype, stream)`` (the kernel before
  its redesign, for a comparison within one call).

``--host N`` times the wrapper's host work per call over ``N`` calls
(``time.perf_counter``, median of each step, ``host_split``).  Prints one
JSON line per variant and per
dtype (registers and spills from ``ptxas -v``, blocks an SM from the CUDA
runtime) and, with ``--out``, writes them all as JSON.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GAUSS_W = [[1, 2, 1], [2, 4, 2], [1, 2, 1]]


def host_split(x, wts, calls: int) -> dict:
    """Median microseconds of each step of ``stencil3x3``'s host work over
    ``calls`` calls of the wrapper itself, each step timed where the wrapper
    and ``CudaLauncher.__call__`` call it (the callee wrapped by a timer,
    the code around it unchanged): the argument checks (``_check``), the
    device check, the weights' tensor, ``plan``, the output's allocation,
    the launcher's device context (made, entered and left), its stream
    lookup and the ctypes call; ``rest`` is what the wrapper took beyond
    them (``x.contiguous()``, the count, the timers' own cost).  Then the
    wrapper and ``F.conv2d`` without timers, and ``plan_stencil``, the
    block height every call computed before the wrapper stopped asking
    for one."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import time_ms
    from repro_torch.core.ubplan import plan_stencil
    from repro_torch.kernels import stencil as st

    cur: dict[str, float] = {}      # microseconds of each step in the call being timed

    def add(name, seconds):
        cur[name] = cur.get(name, 0.0) + 1e6 * seconds

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                add(name, time.perf_counter() - t0)
        return call

    class TimedDevice:
        """``torch.cuda.device`` timed from its making to its exit."""

        def __init__(self, device):
            self.t = 0.0
            self.t, self.ctx = _span(lambda: real_device(device))

        def __enter__(self):
            dt, res = _span(self.ctx.__enter__)
            self.t += dt
            return res

        def __exit__(self, *exc):
            dt, res = _span(lambda: self.ctx.__exit__(*exc))
            add("device_context", self.t + dt)
            return res

    def _span(fn):
        t0 = time.perf_counter()
        res = fn()
        return time.perf_counter() - t0, res

    h, wd = x.shape[0] - 2, x.shape[1] - 2
    conv_x, conv_w = x[None, None], wts.to(x.dtype)[None, None]
    st.stencil3x3(x, wts)           # binds the launcher
    real_device, kernel = torch.cuda.device, st.KERNEL
    saved = [(st, "_check", st._check), (st, "require_cuda", st.require_cuda),
             (st, "plan", st.plan), (torch, "as_tensor", torch.as_tensor),
             (torch, "empty", torch.empty), (torch.cuda, "device", torch.cuda.device),
             (torch.cuda, "current_stream", torch.cuda.current_stream), (kernel, "_fn", kernel._fn)]
    names = {"_check": "check", "require_cuda": "device_check", "plan": "plan",
             "as_tensor": "weights", "empty": "alloc", "current_stream": "stream",
             "_fn": "ctypes_call"}
    per_call = []                   # (the wrapper's microseconds, its steps')
    try:
        for obj, attr, fn in saved:
            setattr(obj, attr, TimedDevice if attr == "device" else timed(names[attr], fn))
        for _ in range(calls):
            cur.clear()
            t0 = time.perf_counter()
            st.stencil3x3(x, wts)
            per_call.append((1e6 * (time.perf_counter() - t0), dict(cur)))
            torch.cuda.synchronize()
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    row = {f"{k}_us": statistics.median(d.get(k, 0.0) for _, d in per_call)
           for k in [*names.values(), "device_context"]}
    row["rest_us"] = statistics.median(t - sum(d.values()) for t, d in per_call)
    untimed = {"wrapper": lambda: st.stencil3x3(x, wts), "conv2d": lambda: F.conv2d(conv_x, conv_w),
               "plan_stencil": lambda: plan_stencil(h, wd, halo=1, dtype_bytes=x.element_size())}
    for name, fn in untimed.items():
        us = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            us.append(1e6 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
        row[f"{name}_us"] = statistics.median(us)
    row["stencil_one_call_ms"] = time_ms(lambda: st.stencil3x3(x, wts), 10)
    row["conv2d_one_call_ms"] = time_ms(lambda: F.conv2d(conv_x, conv_w), 10)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1080,1920", help="H,W of the output")
    ap.add_argument("--dtypes", default="f32,bf16")
    ap.add_argument("--variants", default="plan,regs160x8")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--host", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("stencil_probe.py: no CUDA device is visible", file=sys.stderr)
        return 2
    from chip_smoke import card_line, graph_ms, time_ms
    from repro_torch.backend.build import build_many, digest, load_library, ptxas_usage
    from repro_torch.kernels import stencil as st
    from repro_torch.kernels._cuda import DTYPE_CODE

    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    shipped = st.KERNEL.source()
    sources = {"shipped": shipped}
    variants = args.variants.split(",")
    rows_line = f"constexpr int ROWS = {st.ROWS};"
    assert rows_line in shipped
    for variant in variants:
        if (m := re.fullmatch(r"regs\d+x(\d+)", variant)) and int(m.group(1)) != st.ROWS:
            sources[f"rows{m.group(1)}"] = shipped.replace(
                rows_line, f"constexpr int ROWS = {m.group(1)};")
    if args.baseline:
        sources["base"] = Path(args.baseline).read_text()
        variants.append("base")
    t0 = time.perf_counter()
    secs = build_many(list(sources.values()))
    print(f"[build] {len(secs)} builds, wall {time.perf_counter() - t0:.1f} s", flush=True)
    libs = {name: load_library(src) for name, src in sources.items()}
    h, wd = map(int, args.size.split(","))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rows_out = []
    ok = True
    for dname in args.dtypes.split(","):
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dname]
        code = DTYPE_CODE[dtype]
        x = torch.randint(0, 256, (h + 2, wd + 2), generator=gen, device=dev).to(dtype)
        wts = torch.tensor(GAUSS_W, dtype=torch.float32, device=dev) / 16
        want = st.stencil3x3_plain(x, wts)
        for variant in variants:
            out = torch.empty((h, wd), dtype=dtype, device=dev)
            info = {}
            if variant == "clone":
                row = {"variant": "clone", "dtype": dname, "shape": [h, wd],
                       "ms": time_ms(x.clone, 10), "graph_ms": graph_ms(x.clone), "card": card}
                rows_out.append(row)
                print(json.dumps(row), flush=True)
                continue
            if variant == "plan":
                call = lambda: st.stencil3x3(x, wts)  # noqa: E731
                info = dict(st.plan(h, wd, dtype), blocks_per_sm=st.blocks_per_sm(x))
                src = "shipped"
            elif variant == "base":
                fn = libs["base"].stencil3x3_launch
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                call = lambda fn=fn, out=out: fn(  # noqa: E731
                    x.data_ptr(), wts.data_ptr(), out.data_ptr(), h, wd, code, stream())
                src = "base"
            elif m := re.fullmatch(r"regs(\d+)x(\d+)", variant):
                threads, rows = map(int, m.groups())
                src = "shipped" if rows == st.ROWS else f"rows{rows}"
                fn = libs[src].stencil3x3_launch
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                call = lambda fn=fn, out=out, t=threads: fn(  # noqa: E731
                    x.data_ptr(), wts.data_ptr(), out.data_ptr(), h, wd, code, t, stream())
                info = {"threads": threads, "rows": rows}
            else:
                raise SystemExit(f"bad variant {variant!r}")
            res = call()
            if variant == "plan":
                got = res
            else:
                if res != 0:
                    print(f"[probe] {variant} {dname}: launch refused (cudaError {res})",
                          flush=True)
                    ok = False
                    continue
                got = out
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            ok = ok and same
            usage = ptxas_usage(sources[src])
            row = {"variant": variant, "dtype": dname, "shape": [h, wd], "bit_equal": same,
                   "ms": time_ms(call, 10), "graph_ms": graph_ms(call), **info,
                   "ptxas": usage, "nvcc_s": secs.get(digest(sources[src])), "card": card}
            rows_out.append(row)
            print(json.dumps(row), flush=True)
        if args.host:
            row = {"variant": "host", "dtype": dname, "shape": [h, wd], "calls": args.host,
                   **host_split(x, wts, args.host), "card": card}
            rows_out.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows_out, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
