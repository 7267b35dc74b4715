"""The traced run's ``breakdown``: the device operations that took most
time, named by category and kernel, and the longest idle gaps of the
device, named by what the host was doing."""

from __future__ import annotations

from . import measure
from .trace import Trace

TOP = 10


def category(name: str) -> str:
    """Kernel name → conv / gemm / a fold kernel / copy /
    elementwise_reduce (the categories of the program's profilers)."""
    n = name.lower()
    for kernel in ("warp_fold_bwd", "warp_fold", "fold_place_stream"):
        if kernel in n:
            return kernel
    if "fold_place" in n:
        return "fold_place"
    if "fold_route" in n:
        return "fold_route"
    if "conv" in n or "dgrad" in n or "wgrad" in n or "fprop" in n:
        return "conv"
    if "gemm" in n or "xmma" in n or "cutlass" in n or "nvjet" in n:
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "elementwise_reduce"


def device_ops(trace: Trace) -> list:
    """[[category: kernel, seconds], ...], the TOP longest in total."""
    total: dict = {}
    for name, s, e in trace.device:
        s, e = max(s, trace.start), min(e, trace.end)
        if e > s:
            key = f"{category(name)}: {name[:80]}"
            total[key] = total.get(key, 0) + (e - s)
    top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k, v / 1e9] for k, v in top]


def idle_gaps(trace: Trace) -> list:
    """[[host ranges open at the gap's start, seconds], ...], the TOP
    longest gaps in which the device ran nothing."""
    gaps = measure.idle_gaps(trace.intervals(), trace.start, trace.end)
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[" | ".join(trace.host_at(s)) or "none", (e - s) / 1e9]
            for s, e in gaps[:TOP]]


def breakdown(trace: Trace) -> dict:
    return {"device_ops": device_ops(trace), "idle_gaps": idle_gaps(trace)}
