"""What every hand-written CUDA kernel of the port shares: loading a built
``csrc/<name>.cu`` with its C signatures, launching an entry point on the
device's current stream, and counting the launches.

Each kernel module keeps its own counter (``LAUNCHES``, a dict of kernel
name to launches) and registers it here when it is imported, so that a
caller reads or clears every kernel's launches in one call
(``launch_counts``, ``reset_launch_counts``) and a new kernel module needs
no edit in any caller.
"""

from __future__ import annotations

import ctypes
import threading

import torch

_REGISTERED: list[dict] = []
_lock = threading.Lock()          # replicas launch from a thread each


def register(counts: dict) -> dict:
    """Register a kernel module's ``LAUNCHES``; returns it."""
    with _lock:
        if not any(c is counts for c in _REGISTERED):
            _REGISTERED.append(counts)
    return counts


def count_launch(counts: dict, *names: str) -> None:
    """Add one launch to each of ``names`` in ``counts``."""
    with _lock:
        for name in names:
            counts[name] += 1


def launch_counts() -> dict:
    """{kernel name: launches} over every registered counter."""
    with _lock:
        return {k: v for counts in _REGISTERED for k, v in counts.items()}


def reset_launch_counts() -> None:
    """Set every registered counter to zero."""
    with _lock:
        for counts in _REGISTERED:
            for k in counts:
                counts[k] = 0


def kernel_lib(name: str, n_ptrs: int, n_ints: int,
               entry: str | None = None) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` with its C signatures declared: the
    entry point ``entry(ptrs..., ints..., stream)`` (``entry`` defaults to
    ``name``) and the file's ``<name>_error_string``."""
    from .. import _build
    lib = _build.load(name)
    fn = getattr(lib, entry or name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_void_p]
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
    return lib


def launch(name: str, lib: ctypes.CDLL, device, *args,
           source: str | None = None) -> None:
    """Launch the entry point ``name`` of ``lib`` (built from
    ``csrc/<source>.cu``, ``source`` defaulting to ``name``) on the
    device's current stream; raise with the CUDA error string on failure."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = getattr(lib, f"{source or name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")
