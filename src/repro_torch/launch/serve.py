"""Serving launcher: batched greedy decoding with a reduced config — the
port of the JAX package's ``launch/serve.py``, on the card by default
(``--device cpu --kernels eager`` on the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --reduced --batch 4 --max-new 16
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.models.model import KERNEL_CHOICES
from repro_torch.serve.engine import Request, ServeEngine
from .train import check_route


def main(argv: Optional[Sequence[str]] = None) -> List[Request]:
    """Runs the launcher on ``argv`` (``sys.argv[1:]`` by default); returns
    the served requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--kernels", choices=KERNEL_CHOICES, default="cuda")
    args = ap.parse_args(argv)
    dev = check_route(args.device, args.kernels)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), torch.float32, dev)
    engine = ServeEngine(cfg, params, args.batch,
                         max_seq=args.prompt_len + args.max_new + 1, kernels=args.kernels)

    gen = torch.Generator(dev).manual_seed(42)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=dev).tolist()
    reqs = [Request(prompt=prompts[i], max_new=args.max_new) for i in range(args.batch)]
    t0 = time.time()
    done = engine.run(reqs)
    dt = time.time() - t0
    total_new = sum(len(r.generated) for r in done)
    for i, r in enumerate(done):
        print(f"[serve] req{i}: prompt={r.prompt} -> {r.generated}")
    print(f"[serve] {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s batch={args.batch})")
    return done


if __name__ == "__main__":
    main()
