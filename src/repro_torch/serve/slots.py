"""Fixed-slot padding shared by the port's batched servers."""

from __future__ import annotations

from typing import Callable, List


def pad_to_slots(requests: List, slots: int, make_filler: Callable[[], object]) -> List:
    """Pad a ragged request list up to the engine's fixed slot count with
    filler requests (pad-and-discard: fillers do the slot's work on dummy
    data and their results are thrown away).  Shared by ``ServeEngine``
    (decode slots) and ``backend.serve_bridge.PipelineServer`` (batched
    pipeline slots)."""
    if len(requests) > slots:
        raise ValueError(
            f"{len(requests)} requests exceed the {slots} batch slots"
        )
    return list(requests) + [make_filler() for _ in range(slots - len(requests))]


__all__ = ["pad_to_slots"]
