"""End-to-end training: a ~100M-param LM for a few hundred steps — the
port of the JAX package's ``examples/train_lm.py``, line for line.

It uses the production stack: the data pipeline with prefetch, the
microbatched train step with remat, and AdamW, on a custom ~100M config
(a scaled-down tinyllama shape that still exercises every code path).
The JAX script's docstring also names checkpoint/restore, but its code
calls neither; this port does what that code does
(``repro_torch.launch.train`` is the launcher that checkpoints).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 150]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --kernels eager

On the card (the default) each layer's attention runs the hand-written f32
attention kernel (``kernels/csrc/flash_attention.cu``, D 64) in the forward
and in remat's recompute: 12 layers x 2 microbatches x 2 = 48 launches a
step; its backward is the plain version's gradient (``kernels.grad``) and
the model's products stay ``torch.matmul``, as the JAX model computes them
outside any Pallas kernel.  The weights are drawn from seeded
``torch.Generator``s (0 for the parameters, 1 for the step's state) where
the JAX script draws from ``jax.random``; the batches are the data
pipeline's, the JAX package's for the same seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import check_route, to_device
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import KERNEL_CHOICES, _leaves
from repro_torch.train import (
    AdamWConfig,
    DataPipeline,
    TrainState,
    adamw_init,
    make_train_step,
)

# ~100M params: 12 layers, d_model 640, vocab 32000 (tied embeddings)
LLAMA_100M = dict(name="llama-100m", n_layers=12, d_model=640, n_heads=10, n_kv_heads=5,
                  head_dim=64, d_ff=2560, vocab=32000)
OPT = AdamWConfig(lr=1.5e-3, warmup_steps=20)
MICROBATCHES, KV_CHUNK = 2, 64


def config() -> ModelConfig:
    return dataclasses.replace(get_config("tinyllama_1_1b"), **LLAMA_100M)


def train(cfg: ModelConfig, params, *, steps: int, batch: int, seq: int, kernels: str,
          generator: torch.Generator) -> Dict[str, object]:
    """``steps`` AdamW steps from ``params`` on the data pipeline's batches
    (seed 0); returns the final state, each step's loss, the tokens a
    second over the run and the verdict the JAX script prints."""
    dev = next(t for _, t in _leaves(params)).device
    step_fn = make_train_step(cfg, OPT, microbatches=MICROBATCHES, kv_chunk=KV_CHUNK,
                              remat=True, kernels=kernels)
    state = TrainState(params, adamw_init(params), generator)
    data = DataPipeline(cfg.vocab, batch, seq, seed=0)

    losses = []
    t0 = time.time()
    try:
        for step in range(steps):
            state, metrics = step_fn(state, to_device(next(data), dev))
            losses.append(float(metrics["loss"]))
            if step % 20 == 0 or step == steps - 1:
                tput = batch * seq * (step + 1) / (time.time() - t0)
                print(f"[train_lm] step {step:4d}  loss {losses[-1]:7.4f}  "
                      f"{tput/1e3:6.1f}k tok/s")
    finally:
        data.close()
    wall = time.time() - t0
    n = min(10, len(losses))
    first, last = sum(losses[:n]) / n, sum(losses[-n:]) / n
    verdict = "LEARNING" if last < first - 0.2 else "check convergence"
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} ({verdict})")
    return {"state": state, "losses": losses, "tok_s": batch * seq * steps / wall,
            "wall_s": wall, "first": first, "last": last, "verdict": verdict}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Runs the training on ``argv`` (``sys.argv[1:]`` by default); returns
    ``train``'s result."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--kernels", choices=KERNEL_CHOICES, default="cuda")
    args = ap.parse_args(argv)
    dev = check_route(args.device, args.kernels)

    cfg = config()
    n = cfg.param_count()
    print(f"[train_lm] {cfg.name}: {n/1e6:.1f}M params")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), torch.float32, dev)
    return train(cfg, params, steps=args.steps, batch=args.batch, seq=args.seq,
                 kernels=args.kernels, generator=torch.Generator(dev).manual_seed(1))


if __name__ == "__main__":
    main()
