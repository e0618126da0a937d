"""The port's own spans and counters, for whoever profiles the process.

Spans (:func:`span`) record only while a ``torch.profiler`` session is
active, as torch's own flag says: an operator who profiles the process gets
the program's phases beside the profiler's events, and a process nobody
profiles pays one flag check a span.  Timestamps are ``time.time_ns()``,
the clock kineto stamps its events with, so every span sits on the device
trace's timeline.  Spans are kept here, never emitted as profiler events:
the profiler's event list stays exactly what the program's operations make.

Counters (:func:`add`) are always on; they count at compile boundaries,
and where the serve bridge's non-finite guard engages, never on a warm
path.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

recording = torch._C._autograd._profiler_enabled
LIMIT = 1 << 17                       # spans kept; past it, ``dropped`` counts

_spans: List["Span"] = []
_counters: Dict[str, float] = {}
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()              # read-modify-write of the counts
dropped = 0


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]             # the enclosing span of the same thread
    attrs: dict


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Keep one span whose times the caller took (``time.time_ns()``), with
    no parent: a wait, not a call."""
    _keep(Span(name, start_ns, end_ns, next(_ids), None, attrs))


def _keep(s: Span) -> None:
    global dropped
    if len(_spans) < LIMIT:
        _spans.append(s)
    else:
        with _lock:
            dropped += 1


class _Open:
    """A span being recorded; :meth:`set` adds attributes before it ends."""

    __slots__ = ("name", "attrs", "start_ns", "parent")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Open":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(next(_ids))
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        _keep(Span(self.name, self.start_ns, end, _stack().pop(), self.parent, self.attrs))
        return False


class _Off:
    """The one context :func:`span` returns while nothing records; false."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


def span(name: str, **attrs):
    """A context that records the span ``name`` with ``attrs`` while a
    profiler session is active, else :data:`OFF`.  The context is true when
    it records, so costly attributes can wait for ``if sp: sp.set(...)``."""
    if not recording():
        return OFF
    return _Open(name, attrs)


def spans() -> List[Span]:
    """The spans kept so far, in the order they ended."""
    return list(_spans)


def reset() -> None:
    """Forget every span and the count of dropped ones (counters stay)."""
    global dropped
    with _lock:
        _spans.clear()
        dropped = 0


def add(name: str, value: float) -> None:
    """Add ``value`` to counter ``name`` (always on: off the warm path only)."""
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + value


def counters() -> Dict[str, float]:
    return dict(_counters)


__all__ = ["LIMIT", "OFF", "Span", "add", "counters", "record", "recording", "reset",
           "span", "spans"]
