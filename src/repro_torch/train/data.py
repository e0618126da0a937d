"""Deterministic synthetic token pipeline with background prefetch — a copy
of the JAX package's ``train/data.py`` (numpy and a thread; the batches are
the JAX package's for the same ``(seed, step)``).

Plays the role of the paper's *global buffer* (§VI, Fig. 12): a double-
buffered staging area that hides non-deterministic host latency from the
statically-scheduled accelerator.  The cursor (step index) is part of the
checkpoint, so a restart resumes the exact token stream; sharding is
deterministic in (step, host), so replacement hosts regenerate their shard
(elastic restart).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class DataPipeline:
    def __init__(
        self,
        vocab: int,
        batch: int,
        seq: int,
        *,
        seed: int = 0,
        start_step: int = 0,
        prefetch: int = 2,
        prefix_dim: int = 0,        # vlm/audio stub frontends
        prefix_len: int = 256,
    ):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = start_step
        self.prefix_dim = prefix_dim
        self.prefix_len = prefix_len
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        # learnable synthetic stream: affine recurrences with occasional
        # noise tokens — a model that learns the per-sequence transition
        # rule drives the loss well below log(vocab)
        b, s = self.batch, self.seq + 1
        # a *fixed global* transition rule over a compact alphabet: the model
        # memorizes next = (prev + 1) mod A, with 5% uniform noise — a
        # classic sanity stream whose floor is ~0.05*log(vocab) nats
        alpha = min(256, self.vocab)
        t0 = rng.integers(0, alpha, (b, 1))
        idx = np.arange(s)[None, :]
        toks = (t0 + idx) % alpha
        noise_mask = rng.random((b, s)) < 0.05
        noise = rng.integers(0, self.vocab, (b, s))
        toks = np.where(noise_mask, noise, toks).astype(np.int32)
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.prefix_dim:
            out["prefix_embeds"] = rng.standard_normal(
                (self.batch, self.prefix_len, self.prefix_dim)
            ).astype(np.float32) * 0.02
        return out

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            b = self._make_batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> Dict[str, np.ndarray]:
        step, b = self._q.get()
        self.step = step + 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


__all__ = ["DataPipeline"]
