#!/usr/bin/env python3
"""Compile ConvNeXt-T's stage-3 block on one GPU, check it, and time it
beside plain PyTorch.

    python3 scripts/convnext_probe.py [--batch 32] [--seed 7] [--reps 20] [--out FILE]

Plans the block (``make_app("convnext", img=14, dim=384, hidden=1536)``) at
``--batch`` slots and prints each kernel group: its stages, its hidden chain
(hidden stages, consumer, panel width and count, the hidden panel's register
tile a thread, the panels that take a dead panel's words), shared bytes in
all and by part (scratch, the words reused, the staged copies), the
consumer's and the output's register tiles, registers and spills (``ptxas
-v``) and blocks an SM (the CUDA runtime's occupancy calculator).  Then it
runs the block with the CUDA kernels on inputs drawn as the benchmark's
configuration (``portbench/configs/convnext-t-stage3-14x384.json``) draws
them, holds the output against the plain PyTorch version of the same plan (elements that
differ in any bit, widest gap) and against portbench's reference and its
TF32 control (``max |got - want| / max |want|``), and times one dispatch by
CUDA events (median of ``--reps``, back to back) beside the same block in
plain PyTorch with TF32 off (``F.conv2d``, ``F.layer_norm``, ``F.linear``,
``F.gelu`` over the whole batch).  Prints one JSON line, also written to
``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]


def draw(cfg: dict, batch: int, seed: int, device):
    """The configuration's inputs for ``batch`` slots, each shared input
    drawn once and carried by every slot, as the resident cell holds them."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in sorted(cfg["inputs"]):
        spec = cfg["inputs"][name]
        shape = (1 if spec.get("shared") else batch, *spec["shape"])
        if spec["draw"] == "uniform":
            t = spec["low"] + (spec["high"] - spec["low"]) * torch.rand(
                shape, generator=gen, device=device)
        else:
            t = spec["std"] * torch.randn(shape, generator=gen, device=device)
        out[name] = t.expand(batch, *t.shape[1:]).contiguous() if spec.get("shared") else t
    return out


def plain_block(ins):
    """The block in plain PyTorch over the whole batch (TF32 off by the caller)."""
    import torch.nn.functional as F

    x = ins["ifmap"].permute(0, 3, 1, 2)
    c = x.shape[1]
    wd = ins["dw_weights"][0].permute(2, 0, 1).reshape(c, 1, 7, 7)
    dw = F.conv2d(x, wd, ins["dw_bias"][0], groups=c)
    h = F.layer_norm(dw.permute(0, 2, 3, 1), (c,), ins["ln_weight"][0], ins["ln_bias"][0],
                     eps=1e-6)
    h = F.gelu(F.linear(h, ins["w1"][0], ins["b1"][0]))
    h = F.linear(h, ins["w2"][0], ins["b2"][0])
    return x[:, :, 3:-3, 3:-3].permute(0, 2, 3, 1) + ins["layer_scale"][0] * h


def timed(fn, reps: int) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import reference, spec
    from portbench.reference._precision import no_tf32
    from repro_torch.apps import make_app
    from repro_torch.backend import build, compile_pipeline
    from repro_torch.backend.cuda_codegen import (
        chain_tile, emit_library, output_tile, shared_bytes, smem_layout, staged_inputs)

    dev = torch.device("cuda")
    cfg = spec.load_json(ROOT / "portbench" / "configs" / "convnext-t-stage3-14x384.json")
    app = make_app(cfg["app"], **cfg["kwargs"])
    b = args.batch
    pp = compile_pipeline(app.pipeline, batch=b, batch_capacity=b, device=dev, kernels="cuda")
    usage = build.ptxas_usage(emit_library([k.lg for k in pp.kernels]))
    groups = []
    for i, k in enumerate(pp.kernels):
        kg, ch = k.kg, k.kg.chain
        ct, ot = chain_tile(k.lg), output_tile(k.lg)
        ptx = next((v for n, v in usage.items() if f"ub_kernel_{i}" in n), {})
        reused = sum(4 * math.prod(kg.scratch_shape(kg.stage_plan(t), 0))
                     for t in (ch.takers if ch is not None else ()))
        groups.append({
            "kernel": f"ub_kernel_{i}", "stages": kg.stage_names, "bh": kg.bh,
            "grid": list(kg.grid), "smem": shared_bytes(k.lg), "blocks_per_sm": k.blocks_per_sm(),
            "smem_parts": {"scratch": smem_layout(kg)[2], "reused": reused,
                           "staged": sum(st.smem_bytes for st in staged_inputs(k.lg))},
            "chain": None if ch is None else {"hidden": list(ch.hidden), "consumer": ch.consumer,
                                              "block": ch.block, "panels": ch.count,
                                              "hidden_tile": list(ch.tile),
                                              "reuse": [list(r) for r in ch.reuse]},
            "chain_tile": None if ct is None else [ct.rows, ct.cols, ct.lanes],
            "out_tile": None if ot is None else [ot.rows, ot.cols, ot.lanes], **ptx})
        print(f"group {i}: {json.dumps(groups[-1])}", flush=True)
    ins = draw(cfg, b, args.seed, dev)
    got = pp.run(ins)[app.pipeline.output]
    torch.cuda.synchronize()
    bufs = dict(ins)
    for k in pp.kernels:
        bufs[k.name] = k.plain(bufs)
    want_plain = bufs[app.pipeline.output]
    differ = int((got.view(torch.int32) != want_plain.view(torch.int32)).sum())
    ref = reference.get(cfg["app"])
    want = ref(ins)["convnext"]
    scale = want.abs().flatten(1).amax(1)
    gap = float(((got - want).abs().flatten(1).amax(1) / scale).max())
    ctl = float(((ref(ins, "tf32")["convnext"] - want).abs().flatten(1).amax(1) / scale).max())
    ms = timed(lambda: pp.run(ins), args.reps)
    with no_tf32():
        torch_ms = timed(lambda: plain_block(ins), args.reps)
        yard = plain_block(ins)
    yard_gap = float(((yard - want).abs().flatten(1).amax(1) / scale).max())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    res = {"card": card, "batch": b, "seed": args.seed, "groups": groups,
           "differ_from_plain": differ, "max_abs_vs_plain": float((got - want_plain).abs().max()),
           "max_rel_gap": gap, "tf32_control_gap": ctl, "dispatch_ms": ms,
           "img_per_s": b / ms * 1e3, "torch_ms": torch_ms, "torch_gap": yard_gap}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
