"""Named wall-time spans (reference: src/process_timer.h).

A :class:`ProcessTimer` sums the seconds of each named stage of a run (the
``--metrics-out`` ``stage_seconds`` and the log's timing summary).  Stages
are timed as spans, ``with timer.span(name): ...``, on
``time.perf_counter``'s clock; spans nest, per thread.  Code below the
pipeline that holds no timer opens its spans with the module's
:func:`span`, which adds to the timer of the innermost span open on the
calling thread.

:func:`record_spans` turns recording on for the whole process: each span
that closes is then also kept as ``(name, t0, t1, depth, thread name)``,
depth 1 for the outermost span of its thread.  While a timer's
``profiling`` is set (``--jax-profile``), its spans are also
``torch.profiler.record_function`` ranges.
"""

from __future__ import annotations

import threading
import time

_local = threading.local()       # .stack: the spans open on this thread
_recorded = None                 # the list spans go to while recording


def record_spans(on: bool = True) -> list | None:
    """Turn span recording on or off, process-wide.  On: returns the new
    list every span closed from now on is appended to.  Off: returns the
    list recorded so far (None if recording was off)."""
    global _recorded
    out = _recorded
    _recorded = [] if on else None
    return _recorded if on else out


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("timer", "name", "rest", "t0", "child", "rf")

    def __init__(self, timer, name, rest=None):
        self.timer, self.name, self.rest = timer, name, rest

    def __enter__(self):
        _stack().append(self)
        self.child = 0.0
        self.rf = None
        if self.timer is not None and self.timer.profiling:
            from torch.profiler import record_function
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = _local.stack
        stack.pop()
        seconds = t1 - self.t0
        if stack:
            stack[-1].child += seconds
        timer = self.timer
        if timer is not None:
            timer.add(self.name, seconds)
            if self.rest is not None:
                timer.add(self.rest, seconds - self.child)
        recorded = _recorded
        if recorded is not None:
            recorded.append((self.name, self.t0, t1, len(stack) + 1,
                             threading.current_thread().name))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def span(name: str) -> _Span:
    """A span on the timer of the innermost span open on this thread (on
    none, when no span is open: then it is only recorded)."""
    stack = _stack()
    return _Span(stack[-1].timer if stack else None, name)


class ProcessTimer:
    def __init__(self):
        self.totals = {}
        self.profiling = False
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float):
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds

    def span(self, name: str, rest: str | None = None) -> _Span:
        """A context manager adding its wall seconds to ``name``'s total.
        ``rest`` names a derived total that receives the span's wall less
        that of its direct children on this thread."""
        return _Span(self, name, rest)

    def snapshot(self) -> dict:
        """A copy of the totals (builder threads add to them)."""
        with self._lock:
            return dict(self.totals)

    def summary(self) -> str:
        lines = ["Approximate timing breakdown:"]
        for name, t in self.snapshot().items():
            lines.append(f" {name:24s} = {t:.3f} seconds")
        return "\n".join(lines)
