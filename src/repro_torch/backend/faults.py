"""Deterministic seeded fault injection for the port's serving stack.

The counterpart of the JAX package's ``backend/faults.py``: injectors for
the fault classes of the serve path — a corrupt schedule database, a
poisoned plan-cache entry, NaN/Inf in inputs or in a dispatch's outputs, a
kernel raise at dispatch N, a slow dispatch blowing a deadline — each deterministic (seeded where randomness
is involved) and each a context manager that restores the patched state on
exit.  ``tests/test_torch_faults.py`` asserts that every injected fault
either fully recovers or fails closed with its named error from
:mod:`backend.errors`, never a silent wrong answer.  (The schedule
database and its corruption injector come with the autotuner.)

Injection seams:

* the **schedule database** is a JSON file read through the autotuner's
  mtime-keyed load cache (``autotune._DB_CACHE``):
  :func:`corrupt_schedule_db` rewrites its bytes and drops the cached load;
* the **plan cache** hands out :class:`~repro_torch.backend.runner.TorchPipeline`
  objects: :func:`poison_cache_entry` shadows one pipeline's ``run`` with a
  raiser, on the object a server holds and so in its cache row;
* every batched execution of a :class:`~repro_torch.backend.serve_bridge.PipelineServer`
  goes through its ``_run_pipeline`` bound method: :func:`kernel_raise`,
  :func:`poison_output` and :func:`slow_dispatch` wrap that one seam, so
  no kernel or planner code changes under injection.

The seam's inputs and outputs are tensors on the pipeline's device (the
card by default).  Tile poisoning is marker-based: :func:`mark_poison`
plants ``POISON_MARKER`` in a tile's input, and the output and raise
injectors trigger on the slots whose stacked input holds it, found on the
device with one ``any`` per slot; :func:`poison_output` splats NaN or Inf
over those slots of a clone of each output, so healthy slots stay byte for
byte.  A marker follows its tile through retries and quarantine bisection,
as a data-dependent kernel fault would.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from .runner import TorchPipeline
from .serve_bridge import PipelineServer

# sentinel planted in a tile input to mark it poisoned: large and exactly
# representable in f32, so stacking and the device copy keep it
POISON_MARKER = np.float32(2.0 ** 60)


class InjectedFault(RuntimeError):
    """The exception injected faults raise — deliberately *not* part of the
    :mod:`backend.errors` taxonomy, so a test can tell an injected raw fault
    from the named error the serving layer must turn it into."""


class FaultClock:
    """Deterministic time source for ``PipelineServer(clock=...)``: starts at
    ``t0`` and moves only when :meth:`advance` is called, so a deadline test
    never sleeps.  :func:`slow_dispatch` advances it from inside the
    dispatch seam."""

    def __init__(self, t0: float = 0.0) -> None:
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@contextlib.contextmanager
def _wrap_seam(server: PipelineServer, wrapped) -> Iterator[PipelineServer]:
    server._run_pipeline = wrapped  # type: ignore[method-assign]
    try:
        yield server
    finally:
        if "_run_pipeline" in server.__dict__:
            del server.__dict__["_run_pipeline"]


# ---------------------------------------------------------------------------
# Schedule-db corruption
# ---------------------------------------------------------------------------

DB_CORRUPTIONS = ("truncate", "garbage", "bad-version", "bad-schema")


@contextlib.contextmanager
def corrupt_schedule_db(path: str, mode: str = "truncate") -> Iterator[str]:
    """Corrupt the schedule database at ``path`` for the duration of the
    block; original bytes (or absence) are restored on exit.

    Modes: ``"truncate"`` cuts the JSON mid-document (the partial-write /
    partial-copy failure), ``"garbage"`` replaces it with non-JSON bytes,
    ``"bad-version"`` bumps the version field past ``DB_VERSION``,
    ``"bad-schema"`` keeps valid JSON but drops the ``entries`` key."""
    if mode not in DB_CORRUPTIONS:
        raise ValueError(f"mode must be one of {DB_CORRUPTIONS}: {mode!r}")
    existed = os.path.exists(path)
    original = open(path, "rb").read() if existed else None
    if mode == "truncate":
        doc = original if original is not None else (
            b'{"version": 1, "entries": {"k": {"schedule": {}}}}'
        )
        body = doc[: max(1, len(doc) // 2)]
    elif mode == "garbage":
        body = b"\x00\xffnot json at all\x17"
    elif mode == "bad-version":
        body = json.dumps({"version": 999, "entries": {}}).encode()
    else:                                       # bad-schema
        body = json.dumps({"version": 1, "rows": []}).encode()
    try:
        with open(path, "wb") as f:
            f.write(body)
        # drop the mtime-keyed load cache so the corruption is actually read
        from .autotune import _DB_CACHE

        _DB_CACHE.pop(path, None)
        yield path
    finally:
        if existed:
            with open(path, "wb") as f:
                f.write(original)
        elif os.path.exists(path):
            os.remove(path)
        from .autotune import _DB_CACHE

        _DB_CACHE.pop(path, None)


# ---------------------------------------------------------------------------
# Plan-cache poisoning
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def poison_cache_entry(pp: TorchPipeline) -> Iterator[TorchPipeline]:
    """Make ``pp.run`` raise :class:`InjectedFault` on every call, through
    the object servers hold and through its plan-cache row (the cache holds
    the same object).  Recovery is the serve bridge's retry-with-recompile:
    the entry is dropped and a fresh compile replaces it."""

    def _poisoned_run(inputs):
        raise InjectedFault("poisoned plan-cache entry: this compiled pipeline is broken")

    pp.run = _poisoned_run  # type: ignore[method-assign]
    try:
        yield pp
    finally:
        if "run" in pp.__dict__:
            del pp.__dict__["run"]


# ---------------------------------------------------------------------------
# Tile poisoning (inputs and marker-based output/raise injection)
# ---------------------------------------------------------------------------


def nan_input(
    tiles: List[Dict[str, np.ndarray]],
    frac: float = 0.05,
    seed: int = 0,
    kind: str = "nan",
) -> List[int]:
    """Poison a seeded ``frac`` of ``tiles`` in place with one NaN (or
    ``kind="inf"``) at a seeded coordinate of a seeded input; returns the
    poisoned tile indices, sorted.  At least one tile is poisoned for any
    ``frac > 0``."""
    if not tiles or frac <= 0:
        return []
    rng = np.random.default_rng(seed)
    n_bad = max(1, int(round(frac * len(tiles))))
    picked = sorted(int(i) for i in rng.choice(len(tiles), size=n_bad, replace=False))
    val = np.float32("nan") if kind == "nan" else np.float32("inf")
    for i in picked:
        name = sorted(tiles[i])[int(rng.integers(len(tiles[i])))]
        arr = np.array(tiles[i][name], dtype=np.float32, copy=True)
        arr.flat[int(rng.integers(arr.size))] = val
        tiles[i][name] = arr
    return picked


def mark_poison(tile: Dict[str, np.ndarray], name: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Plant :data:`POISON_MARKER` in one input of ``tile`` (in place; the
    first input by name when ``name`` is None).  The marker is finite, so it
    passes the submit-time guard: it models an in-range input that trips a
    data-dependent kernel fault, which only output quarantine can catch."""
    n = name or sorted(tile)[0]
    arr = np.array(tile[n], dtype=np.float32, copy=True)
    arr.flat[0] = POISON_MARKER
    tile[n] = arr
    return tile


def _marked_slots(ins: Mapping[str, torch.Tensor]) -> List[int]:
    """Slot indices whose stacked input holds the marker, found where the
    inputs lie (one ``any`` per slot and input, one copy of the flags)."""
    marked = None
    for a in ins.values():
        hit = (torch.as_tensor(a) == float(POISON_MARKER)).reshape(a.shape[0], -1).any(1)
        marked = hit if marked is None else marked | hit
    return torch.nonzero(marked).flatten().tolist()


@contextlib.contextmanager
def poison_output(server: PipelineServer, kind: str = "nan") -> Iterator[PipelineServer]:
    """Wrap the dispatch seam so that every slot whose input holds the
    marker gets its outputs splatted with NaN (``kind="inf"``: Inf) after
    the real kernels ran: a mid-pipeline numeric fault that follows the
    tile through bisection.  Each output is cloned on its device before the
    splat, so healthy slots pass through byte for byte."""
    real = server._run_pipeline
    val = float("nan") if kind == "nan" else float("inf")

    def _wrapped(pp: TorchPipeline, ins: Mapping[str, torch.Tensor]):
        bufs = dict(real(pp, ins))
        bad = _marked_slots(ins)
        if bad:
            for name in [ck.name for ck in pp.kernels]:
                arr = bufs[name].clone()
                arr[torch.tensor(bad, device=arr.device)] = val
                bufs[name] = arr
        return bufs

    with _wrap_seam(server, _wrapped):
        yield server


@contextlib.contextmanager
def kernel_raise(
    server: PipelineServer, at_dispatch: Optional[int] = None, on_marker: bool = False
) -> Iterator[PipelineServer]:
    """Make the dispatch seam raise :class:`InjectedFault`: exactly on the
    ``at_dispatch``-th wrapped dispatch (1-based) and never again — the
    transient class, which retry-with-recompile must recover — or, with
    ``on_marker=True``, on every dispatch whose stacked input holds the
    marker — the data-dependent class, which only quarantine bisection can
    isolate.  Exactly one trigger must be chosen."""
    if (at_dispatch is None) == (not on_marker):
        raise ValueError("pass exactly one of at_dispatch / on_marker")
    real = server._run_pipeline
    count = {"n": 0}

    def _wrapped(pp: TorchPipeline, ins: Mapping[str, torch.Tensor]):
        count["n"] += 1
        if at_dispatch is not None and count["n"] == at_dispatch:
            raise InjectedFault(f"injected kernel raise at dispatch {at_dispatch}")
        if on_marker and _marked_slots(ins):
            raise InjectedFault("injected kernel raise: poisoned tile in the batch")
        return real(pp, ins)

    with _wrap_seam(server, _wrapped):
        yield server


@contextlib.contextmanager
def slow_dispatch(
    server: PipelineServer, clock: FaultClock, dispatch_s: float
) -> Iterator[PipelineServer]:
    """Make every dispatch appear to take ``dispatch_s`` seconds on the
    server's :class:`FaultClock` (no real sleeping), so a request whose
    deadline is shorter than one dispatch fails with
    ``DeadlineExceededError``."""
    real = server._run_pipeline

    def _wrapped(pp: TorchPipeline, ins: Mapping[str, torch.Tensor]):
        out = real(pp, ins)
        clock.advance(dispatch_s)
        return out

    with _wrap_seam(server, _wrapped):
        yield server


__all__ = [
    "DB_CORRUPTIONS",
    "FaultClock",
    "InjectedFault",
    "POISON_MARKER",
    "corrupt_schedule_db",
    "kernel_raise",
    "mark_poison",
    "nan_input",
    "poison_cache_entry",
    "poison_output",
    "slow_dispatch",
]
