"""What the port records of itself (``repro_torch.telemetry``), for the
per-layer metrics that read it: the spans its profiled stretch recorded and
its compile counters.  A program without that module, or a process in which
nothing was recorded, gives nothing, and those metrics read ``None``."""

from __future__ import annotations

from typing import List, Optional


def _telemetry():
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    return telemetry


def spans(name: str) -> list:
    """The process's spans called ``name``."""
    t = _telemetry()
    return [s for s in t.spans() if s.name == name] if t else []


def durations_ns(name: str) -> List[int]:
    return [s.end_ns - s.start_ns for s in spans(name)]


def ms_per_img(*names: str) -> Optional[float]:
    """Milliseconds of the spans ``names`` over the requests that the
    ``serve.step`` spans took (their ``live``): both from the profiled
    stretch, where the window's image count covers more."""
    live = sum(s.attrs.get("live", 0) for s in spans("serve.step"))
    found = [d for n in names for d in durations_ns(n)]
    if not live or not found:
        return None
    return 1e-6 * sum(found) / live


def counter(*names: str) -> Optional[float]:
    """The sum of the program's counters ``names``; nothing where it has
    none of them."""
    t = _telemetry()
    have = t.counters() if t else {}
    if not any(n in have for n in names):
        return None
    return sum(have.get(n, 0.0) for n in names)
