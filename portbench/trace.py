"""The measured window, and what its profiler trace holds.

``Window`` synchronises the device, starts the host clock and, when
traced, ``torch.profiler`` (CPU and CUDA activity) with a ``bench.window``
range around the whole window; on exit it synchronises again and stops.
``Trace`` keeps the device's kernel, copy and set intervals, the host's
CPU ranges, and the traced window's own bounds, all in ns on the trace's
clock.
"""

from __future__ import annotations

import dataclasses
import time

import torch

WINDOW_RANGE = "bench.window"


@dataclasses.dataclass
class Trace:
    start: int                 # the window's bounds, ns
    end: int
    device: list               # (name, start, end) kernels, copies, sets
    host: list                 # (name, thread, start, end) CPU ranges

    def kernels(self, needle: str, unless: str | None = None) -> list:
        """Device events whose name holds ``needle`` (and not ``unless``),
        inside the window."""
        return [ev for ev in self.device
                if needle in ev[0] and (unless is None or unless not in ev[0])
                and ev[1] >= self.start and ev[2] <= self.end]

    def intervals(self) -> list:
        return [(s, e) for _, s, e in self.device]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def host_at(self, t: int) -> list[str]:
        """The innermost host range of each thread that is open at ``t``
        (the window's own range left out), one name per thread."""
        inner: dict = {}
        for name, thread, s, e in self.host:
            if s <= t < e and name != WINDOW_RANGE:
                if thread not in inner or s > inner[thread][1]:
                    inner[thread] = (name, s)
        return sorted({name for name, _ in inner.values()})


def _reduce(prof) -> Trace:
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    device, host, bounds = [], [], None
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            if not ev.is_user_annotation() and not name.startswith("bench."):
                device.append((name, s, e))
        else:
            if name == WINDOW_RANGE:
                bounds = (s, e)
            host.append((name, ev.start_thread_id(), s, e))
    if bounds is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE} range")
    if not device:
        raise RuntimeError("the trace holds no device events")
    return Trace(bounds[0], bounds[1], device, host)


class Window:
    """``with Window(trace, device) as win:`` ... the measured work ...;
    then ``win.seconds`` (host clock, synchronised at both ends) and,
    when traced, ``win.trace``."""

    def __init__(self, trace: bool, device: torch.device):
        self.traced = trace
        self.device = torch.device(device)
        self.trace: Trace | None = None
        self.t0 = self.t1 = 0.0
        self._prof = self._range = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        if self.traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._range = torch.profiler.record_function(WINDOW_RANGE)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc):
        self._sync()
        self.t1 = time.perf_counter()
        if self.traced:
            self._range.__exit__(*exc)
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = _reduce(self._prof)
            self._prof = None
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0
