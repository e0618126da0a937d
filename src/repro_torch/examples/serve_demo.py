"""Batched serving demo: greedy decoding with a KV cache on a reduced model,
then the pipeline serve bridge's failure paths — a poisoned submission, a
quarantined tile, a deadline miss, and a backpressure rejection — each
failing closed with its named ``backend.errors`` class while every healthy
request drains bit-exact.  The port of the JAX package's
``examples/serve_demo.py``, line for line.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu --kernels eager]

On the card (the default) the failure paths' gaussian runs the generated
group kernel (``backend/cuda_codegen.py``); decoding launches no
hand-written kernel, as the JAX model's decode reaches no Pallas kernel.
The weights are drawn from a seeded ``torch.Generator`` (seed 0) and the
prompts from ``numpy.random.default_rng(7)``, where the JAX script draws
both from ``jax.random``; the tiles come from ``default_rng(11)`` in both.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import check_route
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import KERNEL_CHOICES
from repro_torch.serve.engine import Request, ServeEngine

SLOTS, MAX_SEQ, PROMPT_LEN, MAX_NEW = 4, 64, 8, 24


def model(dev: torch.device, seed: int = 0):
    """(the reduced tinyllama config, its f32 parameters on ``dev``)."""
    cfg = get_config("tinyllama_1_1b").reduced(n_layers=4, d_model=128)
    return cfg, init_params(cfg, torch.Generator(dev).manual_seed(seed), torch.float32, dev)


def prompts(cfg: ModelConfig, seed: int = 7) -> List[List[int]]:
    """Four prompts of 8 token ids."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in row] for row in rng.integers(0, cfg.vocab, (SLOTS, PROMPT_LEN))]


def greedy(cfg: ModelConfig, params, toks: List[List[int]], kernels: str) -> Dict[str, object]:
    """Greedy decoding of ``toks`` on four slots, then again on a fresh
    engine (the determinism check); returns both runs' requests, the
    wall seconds of the first and whether the streams agree."""
    engine = ServeEngine(cfg, params, SLOTS, max_seq=MAX_SEQ, kernels=kernels)
    reqs = [Request(prompt=list(p), max_new=MAX_NEW) for p in toks]
    t0 = time.time()
    done = engine.run(reqs)
    dt = time.time() - t0
    for i, r in enumerate(done):
        print(f"[serve] req{i}: {r.prompt[:4]}... -> {r.generated[:12]}...")
    total = sum(len(r.generated) for r in done)
    print(f"[serve] {total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s)")

    # determinism check: greedy decode twice gives identical streams
    engine2 = ServeEngine(cfg, params, SLOTS, max_seq=MAX_SEQ, kernels=kernels)
    done2 = engine2.run([Request(prompt=list(p), max_new=MAX_NEW) for p in toks])
    same = all(a.generated == b.generated for a, b in zip(done, done2))
    print(f"[serve] deterministic: {same}")
    return {"done": done, "again": done2, "deterministic": same, "s": dt, "tokens": total}


def failure_paths(device: str = "cuda", kernels: str = "cuda") -> Dict[str, object]:
    """The fault-tolerance contract, live: every failure below is *named*
    (a ``backend.errors`` class printed with its ``[CODE]``), no failure
    touches anyone else's request, and the healthy tiles that drain
    alongside are bit-equal to the per-tile pipeline.  Returns each case's
    error, the server's ``stats()``, whether the healthy tiles agree, the
    healthy requests and all tiles, the server and the per-tile pipeline."""
    from repro_torch.apps.paper_apps import make_app
    from repro_torch.backend import (
        NonFiniteInputError,
        PipelineServer,
        QueueFullError,
        compile_pipeline,
    )
    from repro_torch.backend.faults import FaultClock, mark_poison, poison_output

    print("\n[faults] pipeline serve bridge failure paths")
    app = make_app("gaussian", size=13)
    rng = np.random.default_rng(11)
    shape = tuple(app.pipeline.buffer_boxes["input"].extents)
    tiles = [
        {"input": rng.integers(0, 16, shape).astype(np.float32)}
        for _ in range(6)
    ]
    clock = FaultClock()
    srv = PipelineServer(
        app.pipeline, batch_slots=4, block_h=4,
        max_pending=4, admission="reject", clock=clock, device=device, kernels=kernels,
    )
    errors: Dict[str, object] = {}

    # 1. a NaN submission is rejected at the door — never queued
    poisoned = {"input": tiles[0]["input"].copy()}
    poisoned["input"][3, 3] = np.nan
    try:
        srv.submit(poisoned)
    except NonFiniteInputError as e:
        errors["submit"] = e
        print(f"[faults] submit rejected: {e}")

    # 2. a finite-but-poisoned tile (models a data-dependent kernel bug)
    # is isolated by quarantine bisection; its batch neighbours still serve
    marked = mark_poison({"input": tiles[1]["input"].copy()})
    with poison_output(srv):
        done = srv.run([tiles[0], marked, tiles[2]])
    errors["quarantine"] = done[1].error
    print(f"[faults] quarantined: {done[1].error}")

    # 3. a deadline shorter than the queue wait fails closed, late results
    # are discarded — the deterministic clock makes this reproducible
    late = srv.submit(tiles[3], deadline=0.5)
    clock.advance(2.0)
    srv.step()
    errors["deadline"] = late.error
    print(f"[faults] deadline: {late.error}")

    # 4. a full bounded queue rejects new work by name
    for t in tiles[2:6]:
        srv.submit(t)
    try:
        srv.submit(tiles[0])
    except QueueFullError as e:
        errors["backpressure"] = e
        print(f"[faults] backpressure: {e}")
    while srv.pending:
        srv.step()

    # healthy requests were never disturbed: bit-exact vs per-tile compile
    ref = compile_pipeline(app.pipeline, block_h=4, device=device, kernels=kernels)
    name = app.pipeline.output
    exact = all(
        np.array_equal(r.outputs[name], ref.run(t)[name].cpu().numpy())
        for r, t in ((done[0], tiles[0]), (done[2], tiles[2]))
    )
    s = srv.stats()
    print(
        f"[faults] healthy tiles bit-exact: {exact}; counters: "
        f"poisoned={s['poisoned_tiles']} deadline={s['deadline_misses']} "
        f"rejected={s['validation_rejects']}+{s['backpressure_rejects']} "
        f"served={s['served']} failed={s['failed']}"
    )
    return {"errors": errors, "stats": s, "exact": exact, "healthy": [done[0], done[2]],
            "tiles": tiles, "server": srv, "ref": ref}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Runs the demo on ``argv`` (``sys.argv[1:]`` by default); returns
    ``greedy``'s and ``failure_paths``' results."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--kernels", choices=KERNEL_CHOICES, default="cuda")
    args = ap.parse_args(argv)
    dev = check_route(args.device, args.kernels)

    cfg, params = model(dev)
    serve = greedy(cfg, params, prompts(cfg), args.kernels)
    faults = failure_paths(args.device, args.kernels)
    return {"serve": serve, "faults": faults}


if __name__ == "__main__":
    main()
