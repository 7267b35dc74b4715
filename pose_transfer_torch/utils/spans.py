"""Spans: the program's own named host ranges, recorded while a profiler
records and free while none does.

``span(name, **attrs)`` is a context manager around a piece of work;
``sample(name, value, **attrs)`` records one timestamped value (a
request's queue wait). Both are gated on
``torch.autograd.profiler._is_profiler_enabled``, the process-wide flag
that ``torch.profiler`` sets on start and clears on stop: it is True on
every thread, the batcher's too, where a thread started before the
profiler records no C-level range. With no profiler, ``span`` returns a
shared no-op context after that one attribute read, and ``sample``
returns at once: no ``record_function``, nothing stored.

With a profiler, a span enters a profiler range of its name (the range
shows in the profiler's trace and ``key_averages()`` wherever the profiler
sees the thread) and, on exit, appends one ``Record`` to a
bounded in-memory buffer: its id, the id of the innermost span open on
the same thread when it began (its parent), its name, the thread's
native id, its start and end, and its attributes. Times are
``time.time_ns()``, the Unix-epoch clock on which the profiler reports
its host and device events, so a record lies over the device trace's
intervals as it is. A sample is a record whose start equals its end,
with ``value`` among its attributes.

The range is ``torch._C._profiler._RecordFunctionFast``, the C++ context
manager behind ``torch.profiler.record_function`` without its TorchScript
class object: on an H100 host, a span with ``record_function`` took 33 µs
with the profiler on (11 µs for ``record_function`` alone with it off),
and traced serving read about 10 % fewer images a second than the
untraced program; with the fast range a span costs a few µs and traced
serving read as the program without spans.

``records()`` returns a copy of the buffer, ``clear()`` empties it and
``dropped()`` counts the oldest records that a full buffer gave up.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

MAX_RECORDS = 2 ** 17


class Record(NamedTuple):
    id: int
    parent: int | None     # the enclosing span on the same thread
    name: str
    thread: int            # threading.get_native_id()
    start_ns: int          # time.time_ns()
    end_ns: int
    attrs: dict


_ids = itertools.count(1)
_buffer: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_lock = threading.Lock()
_dropped = 0
_local = threading.local()


def _open() -> list:
    """The ids of the spans open on this thread, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _append(rec: Record) -> None:
    global _dropped
    with _lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(rec)


class _Off:
    """The span while no profiler records: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _open()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._range.__exit__(*exc)
        _open().pop()
        _append(Record(self.id, self.parent, self.name,
                       threading.get_native_id(), self.start, end,
                       self.attrs))
        return False


def span(name: str, **attrs):
    """``with span(name, **attrs) as s:`` ... the work ...; ``s.set(...)``
    adds attributes before the span ends."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def sample(name: str, value: float, **attrs) -> None:
    """Record ``value`` at this instant, under the innermost open span of
    this thread."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _open()
    now = time.time_ns()
    _append(Record(next(_ids), stack[-1] if stack else None, name,
                   threading.get_native_id(), now, now,
                   {**attrs, "value": value}))


def records() -> list[Record]:
    """The buffer's records, oldest first (a copy)."""
    with _lock:
        return list(_buffer)


def clear() -> None:
    """Empty the buffer and zero the drop count."""
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0


def dropped() -> int:
    """Records given up, oldest first, since the last ``clear()``."""
    with _lock:
        return _dropped
