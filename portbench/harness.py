"""What the traffic generators share: the run's context, the inputs drawn
from the seed, and the served path through ``PipelineServer``."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from portbench.check import Reservoir
from portbench.tracing import Off

clock = time.perf_counter


@dataclass
class Run:
    """One run of one cell: ``cell`` as ``spec.cell`` loads it."""

    cell: dict
    seed: int
    seconds: float
    t_start: float                        # the process's start, for setup_s
    device: str = "cuda"
    kernels: str = "cuda"
    tracer: Off = field(default_factory=Off)
    marks: list = field(default_factory=list)     # (set-up step, its end)

    @property
    def config(self) -> dict:
        return self.cell["config"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    @property
    def slots(self) -> int:
        return self.config["batch_slots"]

    def rng(self, stream: int) -> np.random.Generator:
        """Host draws of the run: stream 0 the arrivals, 1 the picks."""
        return np.random.default_rng([self.seed % 2 ** 63, stream])

    def sample(self) -> Reservoir:
        return Reservoir(self.cell["check"]["sample"], self.seed)

    def mark(self, step: str) -> None:
        self.marks.append((step, clock()))

    def sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def app(self):
        from repro_torch.apps import make_app

        app = make_app(self.config["app"], **self.config["kwargs"])
        for name, spec in self.config["inputs"].items():
            if tuple(app.input_extents[name]) != tuple(spec["shape"]):
                raise ValueError(f"{self.config['app']}: input {name!r} is "
                                 f"{app.input_extents[name]} in the app, {spec['shape']} here")
        return app

    def pool(self, images: int) -> Dict[str, torch.Tensor]:
        """``images`` of every input, drawn on the device from the seed in
        one call an input (a ``shared`` input once: one weight tensor for
        all requests, as one deployed layer has)."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed % 2 ** 63)
        out = {}
        for name in sorted(self.config["inputs"]):
            spec = self.config["inputs"][name]
            shape = (1 if spec.get("shared") else images, *spec["shape"])
            if spec["draw"] == "uniform":
                t = torch.rand(shape, generator=gen, device=self.device)
                out[name] = spec["low"] + (spec["high"] - spec["low"]) * t
            elif spec["draw"] == "normal":
                out[name] = spec["std"] * torch.randn(shape, generator=gen, device=self.device)
            else:
                raise ValueError(f"input {name!r}: no draw {spec['draw']!r}")
        return out


def host_inputs(run: Run, images: int):
    """``inputs_of(pick)`` over a pool on the host, as requests carry it:
    image ``pick``'s arrays, each with a leading axis of one."""
    host = {n: t.cpu().numpy() for n, t in run.pool(images).items()}
    shared = {n for n, s in run.config["inputs"].items() if s.get("shared")}

    def inputs_of(pick: int) -> Dict[str, np.ndarray]:
        return {n: a[0:1] if n in shared else a[pick:pick + 1] for n, a in host.items()}

    return inputs_of


class Served:
    """The cell's ``PipelineServer`` (``validate=True``, no deadline) and
    what the window records of it: host seconds in ``submit`` and ``step``,
    each request's latency from when it was due to the end of the
    ``step()`` that returned it (a failed one as ``inf``), and a sample of
    the returned outputs."""

    def __init__(self, run: Run):
        from repro_torch.backend import PipelineServer

        self.run = run
        self.server = PipelineServer(run.app().pipeline, run.slots, validate=True,
                                     device=run.device, kernels=run.kernels)
        run.mark("plan, verify, emit, load")
        self.inputs_of = host_inputs(run, run.traffic["pool"])
        run.mark("pool")
        self.picks = run.rng(1)
        self.latencies: List[float] = []
        self.lateness: List[float] = []
        self.due: Dict[int, tuple] = {}
        self.host_s = 0.0
        self.seams: list = []
        self.sample = run.sample()
        # warm-up: two full dispatches and a ragged one
        for _ in range(2 * run.slots + run.slots // 2):
            self.server.submit(self.request(0))
        while self.server.pending:
            self.server.step()
        run.tracer.warm()
        if run.tracer.traced and run.device == "cuda":
            self._time_seam()
        run.sync()
        run.mark("warm-up")
        self.base = self.server.stats()

    def request(self, pick: int) -> Dict[str, np.ndarray]:
        return {n: a[0] for n, a in self.inputs_of(pick).items()}

    def _time_seam(self) -> None:
        """CUDA events around the server's one dispatch seam: the generated
        kernels' device time of each dispatch."""
        seam = self.server._run_pipeline

        def timed(pp, ins):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = seam(pp, ins)
            b.record()
            self.seams.append((a, b))
            return out

        self.server._run_pipeline = timed

    def pick(self) -> int:
        return int(self.picks.integers(self.run.traffic["pool"]))

    def submit(self, pick: int, due: float) -> None:
        t = clock()
        with self.run.tracer.span("submit"):
            req = self.server.submit(self.request(pick))
        self.host_s += clock() - t
        self.lateness.append(t - due)
        self.due[id(req)] = (pick, due)

    def step(self) -> tuple:
        """One ``step()``; returns the requests that left and its end."""
        t = clock()
        with self.run.tracer.span("step"):
            done = self.server.step()
        end = clock()
        self.host_s += end - t
        for req in done:
            pick, due = self.due.pop(id(req))
            if req.ok:
                self.latencies.append(end - due)
                self.sample.offer((pick, {k: v[None] for k, v in req.outputs.items()}))
            else:
                self.latencies.append(math.inf)
        return done, end

    def record(self, t_open: float, t_close: float) -> dict:
        stats = self.server.stats()
        return {
            "setup_s": t_open - self.run.t_start,
            "window_s": t_close - t_open,
            "attempted": len(self.latencies) + len(self.due),
            "images": sum(math.isfinite(x) for x in self.latencies),
            "missing": len(self.due) + sum(not math.isfinite(x) for x in self.latencies),
            "latencies_s": self.latencies,
            "lateness_s": self.lateness,
            "host_s": self.host_s,
            "seam_s": (sum(a.elapsed_time(b) for a, b in self.seams) * 1e-3
                       if self.seams else None),
            "served": stats["served"] - self.base["served"],
            "dispatches": stats["dispatches"] - self.base["dispatches"],
            "items": self.sample.items,
            "inputs_of": self.inputs_of,
        }

    def close(self) -> None:
        """Drop the program's state; the pool and the sample stay."""
        del self.server
