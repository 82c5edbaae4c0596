"""Host spans inside the program: where the host spends a chunk.

``span(name)`` brackets a stretch of host code; while the recorder is on it
records ``Span(name, parent, t0, t1, thread)`` on ``time.perf_counter()``,
the parent being the innermost span open on the same thread.  Off (the
default) it returns one shared no-op object after a single module-level
check: no allocation, no clock read.  Spans stay in memory until
``drain()`` returns and clears them.

The program's spans (one each where the work happens):

  * ``detect``: ``runtime/pipeline.py::Pipeline.packed_detect``, the plane
    copies, planar letterbox, forward, K1 and unletterbox, queued from the
    host;
  * ``track``: ``Pipeline.track_chunk``, the tracker steps of one chunk;
  * ``sync``: ``ops/assignment.py::greedy_assign``, each device-to-host read
    of the loop's condition; the first one inside a ``track`` span waits for
    the chunk's forward and K1, the others for one greedy round;
  * ``emit``: ``events/zone_engine.py::ZoneEventEngine._emit``, one event's
    alert (JSONL append, webhook or MQTT, log line).

Readers put them on a device trace's clock through the Unix clock (an
offset to ``time.time()``); the ``profiling.trace_dir`` capture
(``trace_summary.start_trace`` / ``stop_trace``) writes them into its trace
that way."""

from __future__ import annotations

import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    parent: str | None     # the innermost span open on the thread at t0
    t0: float              # time.perf_counter() seconds
    t1: float
    thread: int            # threading.get_native_id()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()

_on = False
_recorded: list[Span] = []
_local = threading.local()


class _OpenSpan:
    __slots__ = ("name", "parent", "t0", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].name if stack else None
        self.stack = stack
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.stack.pop()
        _recorded.append(Span(self.name, self.parent, self.t0, t1, threading.get_native_id()))
        return False


def span(name: str):
    """A context manager that records the host time inside it while the
    recorder is on (``NO_SPAN`` while it is off)."""
    if not _on:
        return NO_SPAN
    return _OpenSpan(name)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> list[Span]:
    """The spans recorded since the last drain, in the order they closed;
    clears them."""
    out = _recorded[:]
    del _recorded[:len(out)]
    return out


def unix_offset() -> float:
    """Unix time minus ``time.perf_counter()``, in seconds (the closest of a
    few readings)."""
    best = None
    for _ in range(5):
        a = time.perf_counter()
        u = time.time()
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, u - 0.5 * (a + b))
    return best[1]
