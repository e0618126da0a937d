#!/usr/bin/env python3
"""Split a training microbatch's time on one GPU, and time how the model
takes its layers' parameter slices.

    python3 scripts/train_probe.py [--arch tinyllama_1_1b] [--seq 1024]
        [--layers N] [--reps 3] [--out DIR]

One microbatch (B 1, S ``--seq``, f32, random weights from a seed) of
``train.train_step.microbatch_grads`` on the kernel route, forward and
backward with remat, in two variants of the layer slicing, timed in turns
(unbind, index, index, unbind; CUDA events, median of ``--reps`` each):

- ``unbind``: the model as shipped, every stacked leaf split by one
  ``torch.unbind`` (``models.model._layers``), whose backward stacks the
  layers' gradients once;
- ``index``: ``t[i]`` per layer and leaf, whose backward fills a zero
  gradient of the whole stacked leaf for every layer.

Both must give the same loss and gradients bit for bit.  Then one
microbatch of each variant under ``torch.profiler`` (CPU and CUDA
activities): device time by kernel name, summed and grouped (the
hand-written kernels, matrix products, fills, the rest), written to
``<out>/train_probe_<variant>.txt`` (``build/`` by default).  Prints one
JSON line per variant.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 20261016


def _layers_by_index(stacked):
    from repro_torch.models.model import _leaves, _map

    n = next(t for _, t in _leaves(stacked)).shape[0]
    return [_map(lambda t, i=i: t[i], stacked) for i in range(n)]


def _group(name: str) -> str:
    low = name.lower()
    if "flash_kernel" in low or "flash_wgmma" in low or "ssd_" in low:
        return "hand-written kernels"
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "matrix products"
    if "fill" in low:
        return "fills"
    return "the rest"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("train_probe.py: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, model
    from repro_torch.train.train_step import microbatch_grads

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), torch.float32,
                         "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (1, args.seq + 1), generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    shipped = model._layers
    variants = {"unbind": shipped, "index": _layers_by_index}

    def run(variant):
        model._layers = variants[variant]
        try:
            return microbatch_grads(cfg, params, batch, kv_chunk=128)
        finally:
            model._layers = shipped

    def timed(variant):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a.record()
        out = run(variant)
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b), torch.cuda.max_memory_allocated()

    run("unbind")                                        # warm-up: builds the kernels
    times = {v: [] for v in variants}
    peaks = {}
    results = {}
    for variant in ("unbind", "index", "index", "unbind"):
        for _ in range(args.reps):
            out, ms, peak = timed(variant)
            times[variant].append(ms)
            peaks[variant] = peak
        results[variant] = out
    (lu, gu), (li, gi) = results["unbind"], results["index"]
    same = torch.equal(lu, li) and all(torch.equal(a, b) for a, b in zip(gu, gi))
    del results, gu, gi
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = torch.cuda.get_device_name(0)
    for variant in variants:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(variant)
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:      # CPU ops carry their kernels' time too
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0)
            if dev_us:
                by_kernel[e.key] = by_kernel.get(e.key, 0.0) + dev_us
        groups = {}
        for name, us in by_kernel.items():
            groups[_group(name)] = groups.get(_group(name), 0.0) + us
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:40]
        (out_dir / f"train_probe_{variant}.txt").write_text(
            "\n".join(f"{us / 1e3:10.3f} ms  {name}" for name, us in top) + "\n")
        print(json.dumps({
            "variant": variant, "arch": cfg.name, "layers": cfg.n_layers, "seq": args.seq,
            "card": card, "ms": statistics.median(times[variant]), "runs_ms": times[variant],
            "peak_gib": peaks[variant] / 2**30, "bit_for_bit_with_other": same,
            "profiled_device_ms": sum(by_kernel.values()) / 1e3,
            "device_ms_by_group": {k: v / 1e3 for k, v in sorted(groups.items())},
        }), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
