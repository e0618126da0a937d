"""The profiled stretch of a traced run and its reduction.

A traced run (``--trace 1``) profiles one stretch of its window with
``torch.profiler`` (CPU and CUDA activity), between two synchronizations;
inside the stretch the harness's own calls into the port are
``record_function`` spans named ``portbench.<call>``.  An untraced run gets
:class:`Off`, whose methods do nothing, so the window's loop is the same
code in both.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# kineto's activity types of work on the device
DEVICE_KINDS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
PREFIX = "portbench."
_NULL = contextlib.nullcontext()

Interval = Tuple[int, int, str]          # start ns, end ns, name


class Off:
    """An untraced run: no profiler, no spans."""

    traced = False

    def warm(self) -> None:
        pass

    def tick(self, elapsed_s: float, calls: int) -> None:
        pass

    def span(self, name: str):
        return _NULL

    def finish(self, calls: int) -> None:
        pass

    def result(self) -> Optional[dict]:
        return None


class Stretch(Off):
    """Profiles the part ``[start_s, start_s + length_s)`` of a window; the
    traffic generator calls :meth:`tick` with the seconds since the window
    opened and its count of dispatches so far, at each turn of its loop."""

    traced = True

    def __init__(self, start_s: float, length_s: float, cuda: bool):
        self.start_s, self.end_s = start_s, start_s + length_s
        self.cuda = cuda
        self.prof = None
        self.on = False
        self.t_ns = [0, 0]
        self.calls = [0, 0]

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def warm(self) -> None:
        """Start and stop a profiler once in set-up: the first start in a
        process loads and initializes CUPTI, which must not fall in the
        window."""
        with self._profiler():
            self._sync()

    def tick(self, elapsed_s: float, calls: int) -> None:
        if self.prof is None and elapsed_s >= self.start_s:
            self._sync()
            self.prof = self._profiler()
            self.prof.start()
            self.t_ns[0], self.calls[0], self.on = time.time_ns(), calls, True
        elif self.on and elapsed_s >= self.end_s:
            self.finish(calls)

    def span(self, name: str):
        return torch.profiler.record_function(PREFIX + name) if self.on else _NULL

    def finish(self, calls: int) -> None:
        if self.on:
            self._sync()
            self.t_ns[1], self.calls[1], self.on = time.time_ns(), calls, False
            self.prof.stop()

    def result(self) -> Optional[dict]:
        if self.prof is None:
            return None
        device: List[Interval] = []
        spans: List[Interval] = []
        ops: List[Interval] = []
        for e in self.prof.profiler.kineto_results.events():
            iv = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            kind = _kind(e)
            if kind in DEVICE_KINDS:
                device.append(iv)
            elif kind == "user_annotation":
                spans.append((iv[0], iv[1], iv[2][len(PREFIX):]))
            elif kind == "cpu_op":
                ops.append(iv)
        out = summarize(device, spans, ops, *self.t_ns)
        out["calls"] = self.calls[1] - self.calls[0]
        return out


def _kind(e) -> str:
    """An event's kineto activity type; where the event does not give it
    (torch 2.11), from its device and name: on the device a kernel, copy or
    memset unless it is the device's image of a harness span."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        if kind == "user_annotation" and not e.name().startswith(PREFIX):
            return "other"
        return kind
    harness = e.name().startswith(PREFIX)
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "gpu_user_annotation" if harness else "kernel"
    return "user_annotation" if harness else "cpu_op"


def merge(intervals: Sequence[Interval]) -> List[Tuple[int, int]]:
    """The union of ``intervals`` as sorted, disjoint (start, end) pairs."""
    out: List[List[int]] = []
    for a, b, _ in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _outermost(intervals: Sequence[Interval]) -> Tuple[List[int], List[Interval]]:
    """The intervals that no earlier one contains, sorted, with their starts
    (one host thread: these do not overlap)."""
    top: List[Interval] = []
    for iv in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        if not top or iv[0] >= top[-1][1]:
            top.append(iv)
    return [iv[0] for iv in top], top


def _at(index: Tuple[List[int], List[Interval]], t: int) -> Optional[str]:
    starts, top = index
    i = bisect.bisect_right(starts, t) - 1
    return top[i][2] if i >= 0 and t < top[i][1] else None


def summarize(device: Sequence[Interval], spans: Sequence[Interval],
              ops: Sequence[Interval], t0_ns: int, t1_ns: int) -> dict:
    """Reduce one stretch ``[t0_ns, t1_ns)``: ``window_s``; ``busy_s``, the
    seconds of the stretch in which a kernel, copy or memset ran; ``device_s``, seconds by
    device operation name; ``idle_gaps``, the device's idle seconds summed
    by what the host was doing in each gap (the harness span at
    the gap's middle, then the outermost PyTorch op there), longest first."""
    busy = [(max(a, t0_ns), min(b, t1_ns)) for a, b in merge(device) if b > t0_ns and a < t1_ns]
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, name in device:
        by_name[name] += (b - a) * 1e-9
    gaps: Dict[str, float] = defaultdict(float)
    span_at, op_at = _outermost(spans), _outermost(ops)
    edge = t0_ns
    for a, b in busy + [(t1_ns, t1_ns)]:
        if a > edge:
            mid = (edge + a) // 2
            name = _at(span_at, mid) or "harness"
            op = _at(op_at, mid)
            gaps[name + (f" > {op}" if op else "")] += (a - edge) * 1e-9
        edge = max(edge, b)
    return {
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "device_s": dict(by_name),
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1]),
    }


def breakdown(profile: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time and the longest idle gaps by host activity, at most ``top`` each."""
    ops = sorted(profile["device_s"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in profile["idle_gaps"][:top]]}
