"""SSIM image-quality metric (Wang et al. 2004).

Counterpart of ``pose_transfer_tpu/ops/ssim.py``: an 11×11 Gaussian window
(σ 1.5), K1 = 0.01, K2 = 0.03, valid-mode depthwise filtering per channel,
the map averaged over everything. Plain PyTorch (a depthwise ``conv2d``),
in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise valid-mode 2D filter on an NCHW tensor."""
    c = x.shape[1]
    k = kernel[None, None].expand(c, 1, *kernel.shape)
    return F.conv2d(x, k, groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 2.0,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM between two NHWC image batches (a 0-d f32 tensor).

    ``max_val`` is the dynamic range — 2.0 for the framework's [-1, 1]
    images, 1.0 for [0, 1], 255 for bytes.
    """
    x = img1.float().permute(0, 3, 1, 2)
    y = img2.float().permute(0, 3, 1, 2)
    kernel = _gaussian_kernel(window_size, sigma, x.device)

    mu1 = _filter2d(x, kernel)
    mu2 = _filter2d(y, kernel)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _filter2d(x * x, kernel) - mu1_sq
    sigma2_sq = _filter2d(y * y, kernel) - mu2_sq
    sigma12 = _filter2d(x * y, kernel) - mu12

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()
