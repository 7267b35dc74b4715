"""Model summaries: counterpart of ``pose_transfer_tpu/utils/summary.py``'s
``count_params``."""

from __future__ import annotations

from torch import nn


def count_params(module: nn.Module) -> int:
    """Total parameter count of a module."""
    return sum(p.numel() for p in module.parameters())
