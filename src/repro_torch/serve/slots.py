"""Fixed-slot padding for the port's decode server."""

from __future__ import annotations

from typing import Callable, List


def pad_to_slots(requests: List, slots: int, make_filler: Callable[[], object]) -> List:
    """Pad a ragged request list up to the engine's fixed slot count with
    filler requests (pad-and-discard: fillers do the slot's work on dummy
    data and their results are thrown away).  ``ServeEngine`` pads its
    decode slots with it; ``backend.serve_bridge.PipelineServer`` zeroes
    its filler slots on the device instead."""
    if len(requests) > slots:
        raise ValueError(
            f"{len(requests)} requests exceed the {slots} batch slots"
        )
    return list(requests) + [make_filler() for _ in range(slots - len(requests))]


__all__ = ["pad_to_slots"]
