"""Training launcher: end-to-end driver with checkpoint/restart — the port
of the JAX package's ``launch/train.py``.

It trains on the card through the hand-written attention and SSD kernels
(``--device cuda --kernels cuda``, the default) or on the CPU through the
plain versions (``--device cpu --kernels eager``); ``--kernels cuda`` on
the CPU raises, as ``compile_pipeline`` does.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir build/ckpt

Each asynchronous checkpoint write is joined before ``main`` returns.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.models.model import KERNEL_CHOICES, _resolve_device
from repro_torch.train import (
    AdamWConfig,
    DataPipeline,
    TrainState,
    adamw_init,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.fault import StragglerMonitor


def check_route(device: str, kernels: str) -> torch.device:
    """The device to run on; ``ValueError`` for ``kernels="cuda"`` on the
    CPU, ``RuntimeError`` for the card where none is visible."""
    if kernels == "cuda" and device != "cuda":
        raise ValueError(f"--kernels cuda needs --device cuda, got {device!r}; use "
                         "--kernels eager for the plain versions")
    return _resolve_device(device)


def to_device(batch: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``dev``: token ids as int64, the rest as they are."""
    return {k: torch.from_numpy(v).to(dev, torch.int64 if v.dtype.kind in "iu" else None)
            for k, v in batch.items()}


def main(argv: Optional[Sequence[str]] = None) -> Tuple[TrainState, List[Dict]]:
    """Runs the launcher on ``argv`` (``sys.argv[1:]`` by default); returns
    the final state and one record a step run (``step``, ``loss``,
    ``grad_norm``, ``s``: its host seconds, which end in a synchronize)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--kernels", choices=KERNEL_CHOICES, default="cuda")
    args = ap.parse_args(argv)
    dev = check_route(args.device, args.kernels)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.2f}M params, "
          f"family={cfg.family}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20,
                          compress_grads=args.compress_grads)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              kv_chunk=min(128, args.seq), remat=True, kernels=args.kernels)

    params = init_params(cfg, torch.Generator(dev).manual_seed(0), torch.float32, dev)
    state = TrainState(params, adamw_init(params), torch.Generator(dev).manual_seed(1))
    del params
    start = 0

    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            p, o, meta = restore_checkpoint(args.ckpt_dir, last, state.params, state.opt)
            state = TrainState(p, o, torch.Generator(dev).manual_seed(1))
            del p, o
            start = meta["step"]
            print(f"[train] restored step {start} from {args.ckpt_dir}")

    data = DataPipeline(
        cfg.vocab, args.batch, args.seq, seed=0, start_step=start,
        prefix_dim=cfg.d_model if cfg.frontend != "none" else 0,
    )
    monitor = StragglerMonitor()
    history: List[Dict] = []
    writers = []
    t_start = time.time()
    try:
        for step in range(start, args.steps):
            batch = to_device(next(data), dev)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            gnorm = float(metrics["grad_norm"])
            history.append({"step": step, "loss": loss, "grad_norm": gnorm, "s": dt})
            if monitor.observe(step, dt):
                print(f"[train] step {step}: straggler ({dt:.3f}s)")
            if step % args.log_every == 0 or step == args.steps - 1:
                toks = args.batch * args.seq / dt
                print(f"[train] step {step:5d} loss={loss:8.4f} "
                      f"gnorm={gnorm:7.3f} "
                      f"{dt*1e3:7.1f}ms {toks/1e3:7.1f}k tok/s")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                writers.append(save_checkpoint(args.ckpt_dir, step + 1, state.params,
                                               state.opt, data.state(), async_save=True))
    finally:
        data.close()
        for w in writers:
            w.join()
    print(f"[train] done in {time.time()-t_start:.1f}s")
    return state, history


if __name__ == "__main__":
    main()
