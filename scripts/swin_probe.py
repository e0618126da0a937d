#!/usr/bin/env python3
"""Compile Swin-T's stage-3 block pair on one GPU, check it, and time it,
each kernel group and beside plain PyTorch.

    python3 scripts/swin_probe.py [--batch 32] [--seed 7] [--reps 20] [--window-blocks N]
                                  [--gap-seeds N] [--out FILE]

Plans the pair (``make_app("swin", img=14, dim=384, heads=12, window=7,
hidden=1536, shift=3)``) at ``--batch`` slots and prints each kernel group:
its stages, its window-attention tile (score, statistics, windows, masked
windows) or hidden chain, shared bytes, threads, registers and spills
(``ptxas -v``) and blocks an SM (the CUDA runtime's occupancy calculator),
and the library's build seconds.  Then it runs the pair with the CUDA
kernels on inputs drawn as the benchmark's configuration
(``portbench/configs/swin-t-stage3-14x384.json``) draws them, holds the
output against the plain PyTorch version of the same plan (elements that
differ in any bit, widest gap) and against portbench's reference and its
TF32 control (``max |got - want| / max |want|``), and times one dispatch and
each group's kernel by CUDA events (median of ``--reps``, back to back)
beside the same pair in plain PyTorch with TF32 off (the reference's
modules, each called once over every window of the batch; its gap to the
reference is printed too).  ``--window-blocks`` builds the
window-attention kernels for that many blocks an SM
(``cuda_codegen.WINDOW_BLOCKS``).  ``--gap-seeds N`` then draws the
resident cell's whole pool (8 batches) from each of N large seeds as its
runs do (``portbench.harness.Run.pool``) and reports, for each, the widest
gap of all its images to the reference and the TF32 control's widest and
narrowest: the readings the cell's ``max_rel_gap`` is set between.  Prints
one JSON line, also written to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

CONFIG = ROOT / "portbench" / "configs" / "swin-t-stage3-14x384.json"


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


def plain_pair(ins):
    """The pair in plain PyTorch over the whole batch at once, Swin's
    modules as the reference writes them (window partition, relative
    position bias, region mask, ``F.softmax``, ``F.gelu``) with the shared
    weights of slot 0: every window of every image in one call a module,
    the bias gathered and the mask built once, on the device, before the
    returned callable runs (TF32 off by the caller)."""
    import torch
    import torch.nn.functional as F

    from portbench.reference import swin

    x = ins["ifmap"]
    nb, n, m, _, _, c = x.shape
    hw, L = n * m, m * m
    heads = ins["b1_rel_bias"].shape[-1]
    hd = c // heads
    index = swin.relative_position_index(m).to(x.device).view(-1)
    mask = swin.attention_mask(hw, hw, m, m // 2).to(x.device)[None, :, None]
    blocks = []
    for k, shift in ((1, 0), (2, m // 2)):
        w = {name: ins[f"b{k}_{name}"][0] for name in swin.BLOCK}
        w["qkv_w"], w["qkv_b"] = w["qkv_w"].reshape(3 * c, c), w["qkv_b"].reshape(3 * c)
        w["proj_w"] = w["proj_w"].reshape(c, c).t().contiguous()
        w["bias"] = (w["rel_bias"].reshape(-1, heads)[index].view(L, L, heads)
                     .permute(2, 0, 1).contiguous())
        blocks.append((w, shift))

    def block(y, w, shift):
        t = F.layer_norm(y, (c,), w["ln1_weight"], w["ln1_bias"], eps=1e-5)
        if shift:
            t = torch.roll(t, shifts=(-shift, -shift), dims=(1, 2))
        win = t.view(nb, n, m, n, m, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, L, c)
        qkv = F.linear(win, w["qkv_w"], w["qkv_b"]).reshape(-1, L, 3, heads, hd)
        q, k_, v = qkv.permute(2, 0, 3, 1, 4)
        a = (q * hd ** -0.5) @ k_.transpose(-2, -1) + w["bias"]
        if shift:
            a = (a.view(nb, n * n, heads, L, L) + mask).view(-1, heads, L, L)
        o = (F.softmax(a, dim=-1) @ v).transpose(1, 2).reshape(-1, L, c)
        o = F.linear(o, w["proj_w"], w["proj_b"])
        o = o.view(nb, n, n, m, m, c).permute(0, 1, 3, 2, 4, 5).reshape(nb, hw, hw, c)
        if shift:
            o = torch.roll(o, shifts=(shift, shift), dims=(1, 2))
        y = y + o
        t = F.layer_norm(y, (c,), w["ln2_weight"], w["ln2_bias"], eps=1e-5)
        t = F.gelu(F.linear(t, w["fc1_w"], w["fc1_b"]), approximate="none")
        return y + F.linear(t, w["fc2_w"], w["fc2_b"])

    def run():
        y = x.reshape(nb, hw, hw, c)
        for w, shift in blocks:
            y = block(y, w, shift)
        return y.reshape(x.shape)

    return run


def seed_gaps(pp, ref, seed: int) -> dict:
    """The resident cell's pool drawn from ``seed`` as its runs draw it,
    every batch run: the widest gap of an image to the reference, and the
    TF32 control's widest (what the cell's check would read in the
    program's place) and narrowest."""
    import torch

    from portbench import spec
    from portbench.harness import Run

    cell = spec.cell("swin-t-stage3-14x384.resident")
    run = Run(cell, seed, 0.0, 0.0)
    slots, count = run.slots, cell["traffic"]["batches"]
    shared = {n for n, s in cell["config"]["inputs"].items() if s.get("shared")}
    pool = {n: t.expand(slots, *t.shape[1:]).contiguous() if n in shared else t
            for n, t in run.pool(slots * count).items()}
    gap, ctl, ctl_max = 0.0, float("inf"), 0.0
    for j in range(count):
        ins = {n: t if n in shared else t[j * slots:(j + 1) * slots] for n, t in pool.items()}
        got = pp.run(ins)["swin"]
        want = ref(ins)["swin"]
        scale = want.abs().flatten(1).amax(1)
        gap = max(gap, float(((got - want).abs().flatten(1).amax(1) / scale).max()))
        c = ref(ins, "tf32")["swin"]
        per = (c - want).abs().flatten(1).amax(1) / scale
        ctl, ctl_max = min(ctl, float(per.min())), max(ctl_max, float(per.max()))
        torch.cuda.synchronize()
    return {"seed": seed, "max_rel_gap": gap, "tf32_gap": ctl_max, "tf32_min_image_gap": ctl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--window-blocks", type=int, default=None)
    ap.add_argument("--gap-seeds", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import reference, spec
    from portbench.reference._precision import no_tf32
    from repro_torch.apps import make_app
    from repro_torch.backend import build, compile_pipeline, cuda_codegen
    from repro_torch.backend.cuda_codegen import block_threads, emit_library, shared_bytes

    if args.window_blocks is not None:
        cuda_codegen.WINDOW_BLOCKS = args.window_blocks

    dev = torch.device("cuda")
    cfg = spec.load_json(CONFIG)
    app = make_app(cfg["app"], **cfg["kwargs"])
    b = args.batch
    t0 = time.perf_counter()
    pp = compile_pipeline(app.pipeline, batch=b, batch_capacity=b, device=dev, kernels="cuda")
    compile_s = time.perf_counter() - t0
    usage = build.ptxas_usage(emit_library([k.lg for k in pp.kernels]))
    ins = draw(cfg, b, args.seed, dev)
    got = pp.run(ins)[app.pipeline.output]
    torch.cuda.synchronize()
    bufs = dict(ins)
    for k in pp.kernels:
        bufs[k.name] = k.plain(bufs)
    groups = []
    for i, k in enumerate(pp.kernels):
        kg, wa, ch = k.kg, k.kg.window, k.kg.chain
        ptx = next((v for n, v in usage.items() if f"ub_kernel_{i}" in n), {})
        groups.append({
            "kernel": f"ub_kernel_{i}", "stages": kg.stage_names, "bh": kg.bh,
            "grid": list(kg.grid), "threads": block_threads(k.lg), "smem": shared_bytes(k.lg),
            "blocks_per_sm": k.blocks_per_sm(),
            "ms": timed(lambda k=k: k(bufs), args.reps),
            "window": None if wa is None else {"score": wa.score, "stats": list(wa.stats),
                                               "windows": wa.windows, "keys": wa.keys,
                                               "masked": wa.masked},
            "chain": None if ch is None else {"consumer": ch.consumer, "block": ch.block,
                                              "panels": ch.count},
            **ptx})
        print(f"group {i}: {json.dumps(groups[-1])}", flush=True)
    want_plain = bufs[app.pipeline.output]
    differ = int((got.view(torch.int32) != want_plain.view(torch.int32)).sum())
    ref = reference.get(cfg["app"])
    want = ref(ins)["swin"]
    scale = want.abs().flatten(1).amax(1)
    gap = float(((got - want).abs().flatten(1).amax(1) / scale).max())
    ctl = float(((ref(ins, "tf32")["swin"] - want).abs().flatten(1).amax(1) / scale).max())
    ms = timed(lambda: pp.run(ins), args.reps)
    with no_tf32():
        pair = plain_pair(ins)
        torch_gap = float(((pair() - want).abs().flatten(1).amax(1) / scale).max())
        torch_ms = timed(pair, args.reps)
    seeds = []
    for i in range(args.gap_seeds):
        seeds.append(seed_gaps(pp, ref, 2 ** 31 + 101 + 37 * i))
        print(f"seed: {json.dumps(seeds[-1])}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    res = {"card": card, "batch": b, "seed": args.seed, "compile_s": compile_s,
           "window_blocks": cuda_codegen.WINDOW_BLOCKS, "groups": groups,
           "differ_from_plain": differ, "max_abs_vs_plain": float((got - want_plain).abs().max()),
           "max_rel_gap": gap, "tf32_control_gap": ctl, "dispatch_ms": ms,
           "img_per_s": b / ms * 1e3, "groups_ms": sum(g["ms"] for g in groups),
           "torch_ms": torch_ms, "torch_max_rel_gap": torch_gap, "seeds": seeds}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
