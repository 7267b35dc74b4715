"""Both packages' ``transforms_host`` compiled from source, for exact tests.

The host fits (``estimate_uniform_transform``, the head of
``affine_transforms``) take their points in a set's order, and a set display
of three or more constant strings compiles to a frozenset constant. A module
compiled from source builds that constant in source order; one loaded from a
``.pyc`` rebuilds it in the order the writing process iterated it, which
follows that process's hash seed. For some seeds the two iterate differently,
and ``np.linalg.lstsq`` then fits the same points ~5e-14 apart. The tests that
hold the port's fits to the JAX package's bit for bit run both packages
through copies compiled here, in this process, so both sides see one order.
"""

import importlib
import types

import pytest

PACKAGES = ("pose_transfer_torch", "pose_transfer_tpu")
_copies = {}


def source_copy(package):
    """``<package>.core.transforms_host`` compiled from its source file,
    under a module name of its own."""
    if package not in _copies:
        name = f"{package}.core.transforms_host"
        path = importlib.util.find_spec(name).origin
        mod = types.ModuleType(f"{name}_from_source")
        mod.__package__, mod.__file__ = f"{package}.core", path
        with open(path) as f:
            exec(compile(f.read(), path, "exec"), mod.__dict__)
        _copies[package] = mod
    return _copies[package]


@pytest.fixture
def fits_from_source(monkeypatch):
    """Route both packages' host fits, direct and through their ``data``
    modules, to the source-compiled copies; yields (port's, JAX's)."""
    copies = []
    for package in PACKAGES:
        copy = source_copy(package)
        for name in ("data.dataset", "data.synthetic"):
            mod = importlib.import_module(f"{package}.{name}")
            if hasattr(mod, "th"):
                monkeypatch.setattr(mod, "th", copy)
        # for imports made inside a function
        monkeypatch.setattr(importlib.import_module(f"{package}.core"),
                            "transforms_host", copy)
        copies.append(copy)
    return tuple(copies)
