"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ``ctypes``.
Builds happen at first use, into ``_build/`` beside this file (listed in
``.gitignore``), under a name that carries the hash of the source and the
flags: an edited source rebuilds, an unchanged one loads at once. All
sources compile in parallel, one ``nvcc`` each, started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every stale source (in parallel); return {name: ptxas
    report} for the sources compiled by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        so = _target(src)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = {}, []
    for src, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, so)   # atomic: a concurrent loader never sees half
        reports[src.stem] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = _target(CSRC / f"{name}.cu")
            if not so.exists():
                build_all()
            lib = _libs[name] = ctypes.CDLL(str(so))
        return lib
