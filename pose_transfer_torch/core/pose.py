"""Pose geometry on tensors: keypoints → Gaussian heatmaps, the stacked
generator's pose interpolation, image scaling and the packed-input channel
contract.

Counterpart of ``pose_transfer_tpu/core/pose.py``. Heatmaps are NHWC
(..., H, W, K), as in the JAX package. Its ``map_to_cord`` (the heatmap
decode) is ``utils.visualize.map_to_cord`` here, in numpy: the grids are
its one user. The host data path interpolates with the numpy twin
``data.annotations.interpolate_keypoints_host``.
"""

from __future__ import annotations

import torch

from .skeletons import MISSING_VALUE


def cords_to_map(cords: torch.Tensor, img_size: tuple[int, int],
                 sigma: float = 6.0) -> torch.Tensor:
    """Rasterize keypoints into Gaussian heatmaps.

    Args:
      cords: (..., K, 2) (y, x) keypoints; a coordinate equal to
        ``MISSING_VALUE`` (-1) marks a missing joint, whose channel is all
        zeros.
      img_size: (H, W).
      sigma: Gaussian std in pixels (reference default 6).

    Returns:
      (..., H, W, K) float32 heatmaps exp(-((y-cy)²+(x-cx)²)/(2σ²)), on
      ``cords``' device.
    """
    h, w = img_size
    cords = cords.to(torch.float32)
    cy = cords[..., 0][..., None, None, :]                     # (..., 1, 1, K)
    cx = cords[..., 1][..., None, None, :]
    yy = torch.arange(h, dtype=torch.float32,
                      device=cords.device)[:, None, None]      # (H, 1, 1)
    xx = torch.arange(w, dtype=torch.float32,
                      device=cords.device)[None, :, None]      # (1, W, 1)
    d2 = (yy - cy).square() + (xx - cx).square()
    maps = torch.exp(-d2 / (2.0 * sigma ** 2))
    missing = (cords[..., 0] == MISSING_VALUE) | (cords[..., 1] == MISSING_VALUE)
    return torch.where(missing[..., None, None, :],
                       torch.zeros((), dtype=maps.dtype, device=maps.device),
                       maps)


def compute_interpol_pose(inp_pose: torch.Tensor, tg_pose: torch.Tensor,
                          index: int, num_stacks: int,
                          pose_dim: int) -> torch.Tensor:
    """Linear keypoint interpolation for the stacked generator, (..., K, 2)
    float32.

    For pose_dim 16 a plain lerp. For pose_dim 18 a joint missing on one
    side appears or vanishes at the halfway stack: missing in the input
    and present in the target, it is MISSING for ``index <= num_stacks //
    2`` and the target after; present in the input and missing in the
    target, the input, then MISSING; missing on both sides, MISSING.
    """
    inp_pose = torch.as_tensor(inp_pose).to(torch.float32)
    tg_pose = torch.as_tensor(tg_pose).to(torch.float32)
    frac = index / num_stacks
    lerp = inp_pose + (tg_pose - inp_pose) * frac
    if pose_dim == 16:
        return lerp
    inp_missing = (inp_pose == MISSING_VALUE).any(dim=-1, keepdim=True)
    tg_missing = (tg_pose == MISSING_VALUE).any(dim=-1, keepdim=True)
    missing = torch.full_like(lerp, MISSING_VALUE)
    if index <= num_stacks // 2:
        case_inp, case_tg = missing, inp_pose
    else:
        case_inp, case_tg = tg_pose, missing
    out = torch.where(inp_missing & ~tg_missing, case_inp, lerp)
    out = torch.where(tg_missing & ~inp_missing, case_tg, out)
    return torch.where(inp_missing & tg_missing, missing, out)


def interpol_pose_sequence(inp_pose: torch.Tensor, tg_pose: torch.Tensor,
                           num_stacks: int, pose_dim: int) -> torch.Tensor:
    """All ``num_stacks`` interpolated poses, the last one the target:
    (num_stacks, ..., K, 2)."""
    return torch.stack([
        compute_interpol_pose(inp_pose, tg_pose, i, num_stacks, pose_dim)
        for i in range(1, num_stacks + 1)])


def preprocess_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] → float32 [-1, 1]."""
    return (image.to(torch.float32) / 255.0 - 0.5) * 2.0


def deprocess_image(image: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] → uint8 [0, 255] (truncating, as the reference)."""
    return (255.0 * (image + 1.0) / 2.0).to(torch.uint8)


def get_imgpose(inp: torch.Tensor, use_input_pose: bool, pose_dim: int):
    """Split the packed NHWC input into (image, input pose, target pose).

    Channel contract: [0:3] RGB, [3:3+K] input pose (when
    ``use_input_pose``), remainder target pose. Without the input pose the
    target starts at channel 6, not 3 — the reference's quirk, kept.
    """
    inp_img = inp[..., :3]
    inp_pose = inp[..., 3:3 + pose_dim] if use_input_pose else None
    tg_start = 3 + pose_dim if use_input_pose else 6
    tg_pose = inp[..., tg_start:]
    return inp_img, inp_pose, tg_pose


def pack_input(image: torch.Tensor, inp_pose_map: torch.Tensor | None,
               tg_pose_map: torch.Tensor) -> torch.Tensor:
    """Concatenate [image ‖ (input pose) ‖ target pose] on channels (NHWC)."""
    parts = [image]
    if inp_pose_map is not None:
        parts.append(inp_pose_map)
    parts.append(tg_pose_map)
    return torch.cat(parts, dim=-1)
