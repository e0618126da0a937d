"""Quickstart: compile a Halide-style stencil through the paper's compiler
(schedule, unified buffers, memory mapping, cycle-accurate simulation), then
run the same stencil as the port's hand-written kernel on the card.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

Steps 1-4 are host work on the port's copies of the paper's core.  Step 5
runs ``kernels.ops.stencil3x3_op`` on the card (the CUDA kernel) on a 64x64
input and holds it bit for bit against its plain version and, within
``ORACLE_TOL``, against the oracle ``ref.stencil3x3_ref``; ``--device cpu``
runs the plain version in its place, and says so.  There is no fallback:
the default device is the card, and with no visible GPU step 5's device
raises before step 1 starts.  Exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch

from repro_torch.apps import make_app
from repro_torch.backend.runner import resolve_device
from repro_torch.core.extraction import extract_buffers
from repro_torch.core.mapping import map_design
from repro_torch.core.scheduling import schedule_pipeline, schedule_sequential
from repro_torch.core.simulator import validate_against_reference, validate_mapped_buffers
from repro_torch.kernels import ref, stencil
from repro_torch.kernels.ops import stencil3x3_op

# the oracle accumulates in the input dtype, the kernel in f32: for an f32
# input the two may round differently in the last place
ORACLE_TOL = 1e-5
GAUSS_W = [[1, 2, 1], [2, 4, 2], [1, 2, 1]]


def run(device: str = "cuda", seed: int = 0, out=print) -> Dict[str, object]:
    """The five steps; returns what they found (``problems`` empty when
    every check passed)."""
    dev = resolve_device(device)
    kernels = "cuda" if dev.type == "cuda" else "eager"
    problems: List[str] = []

    # 1. the app: gaussian 3x3 over a 64x64 input tile (paper Fig. 1 class)
    app = make_app("gaussian")
    out(f"app: {app.name} — {app.description}")
    out(f"stages: {[s.name for s in app.pipeline.stages]}")

    # 2. cycle-accurate schedule (paper §V-B)
    sched = schedule_pipeline(app.pipeline)
    seq = schedule_sequential(app.pipeline)
    out(f"policy={sched.policy}  completion={sched.completion} cycles "
        f"(naive sequential: {seq.completion}; paper: 4102 vs 27159)")

    # 3. unified buffers (paper §III) + mapping (paper §V-C)
    ex = extract_buffers(app.pipeline, sched)
    for name, ub in ex.buffers.items():
        out(f"buffer {name}: {len(ub.in_ports)} in / {len(ub.out_ports)} out "
            f"ports, capacity bound {ub.capacity_bound()} words")
    mapped = map_design(ex.buffers)
    for name, mb in mapped.items():
        out(f"mapped {name}: {len(mb.sr_taps)} SR taps, "
            f"{mb.mem_tiles} MEM tile(s), {mb.sram_words} SRAM words")

    # 4. validate: cycle-accurate simulation == reference interpreter
    small = make_app("gaussian", size=16)
    ssched = schedule_pipeline(small.pipeline)
    rng = np.random.default_rng(seed)
    inputs = {n: rng.integers(0, 64, s).astype(float) for n, s in small.input_extents.items()}
    sim_problems = validate_against_reference(small.pipeline, ssched, inputs)
    sex = extract_buffers(small.pipeline, ssched)
    sim_problems += validate_mapped_buffers(sex, map_design(sex.buffers))
    out(f"simulation vs reference: {'OK' if not sim_problems else sim_problems}")
    problems += [f"simulation: {p}" for p in sim_problems]

    # 5. the H100 retargeting: the same stencil as a hand-written kernel
    x = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)).to(dev)
    w = torch.tensor(GAUSS_W, dtype=torch.float32, device=dev) / 16.0
    plan = stencil.plan(62, 62, torch.float32)
    out(f"stencil plan: {plan}")
    if kernels == "eager":
        out("device cpu: step 5 runs the plain PyTorch version, not the CUDA kernel")
    got = stencil3x3_op(x, w, kernels=kernels)
    plain = stencil3x3_op(x, w, kernels="eager")
    want = ref.stencil3x3_ref(x, w)
    finite = bool(torch.isfinite(got).all())
    plain_err = float((got - plain).abs().max())
    oracle_err = float((got - want).abs().max())
    label = "CUDA kernel" if kernels == "cuda" else "plain version"
    out(f"{label} vs plain version: max abs err {plain_err!r} (bit for bit expected)")
    out(f"{label} vs oracle: max abs err {oracle_err:.2e} (tolerance {ORACLE_TOL:g})")
    if tuple(got.shape) != (62, 62) or not finite:
        problems.append(f"stencil: output shape {tuple(got.shape)}, finite {finite}")
    if not torch.equal(got, plain):
        problems.append(f"stencil: {label} differs from the plain version by {plain_err!r}")
    if oracle_err > ORACLE_TOL:
        problems.append(f"stencil: {label} differs from the oracle by {oracle_err!r}")
    return {
        "device": str(dev), "kernels": kernels, "completion": sched.completion,
        "sequential": seq.completion, "plan": plan, "plain_err": plain_err,
        "oracle_err": oracle_err, "problems": problems,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where step 5 runs: the CUDA kernel on the card (default) "
                         "or its plain version on the CPU")
    args = ap.parse_args(argv)
    res = run(args.device)
    for p in res["problems"]:
        print(f"MISMATCH: {p}", file=sys.stderr)
    return 1 if res["problems"] else 0


if __name__ == "__main__":
    sys.exit(main())
