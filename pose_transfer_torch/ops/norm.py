"""Volume instance normalization — the reference's Block norm quirk.

Counterpart of ``pose_transfer_tpu/ops/norm.py``. The reference applies
``nn.InstanceNorm3d(1, eps=1e-3, affine=True)`` to the activation viewed as
(N, 1, C, H, W): statistics over the whole (C, H, W) volume per sample and
one scalar weight/bias pair per layer — not per-channel instance norm.
"""

from __future__ import annotations

import torch


def volume_instance_norm(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Normalize over every non-batch dimension per sample, scalar affine.

    Layout-free: the stats cover dims 1..3, so NHWC and NCHW inputs give
    the same result. One-pass f32 stats (E[x], E[x²]), biased variance
    clamped at 0, eps inside the rsqrt; the output has ``x``'s dtype.
    """
    dtype = x.dtype
    x32 = x.to(torch.float32)
    dims = tuple(range(1, x.ndim))
    mean = x32.mean(dim=dims, keepdim=True)
    msq = x32.square().mean(dim=dims, keepdim=True)
    var = torch.clamp(msq - mean.square(), min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(dtype)
