"""Device-side batch preparation: compact host batch → model-ready tensors.

Counterpart of the baseline branch of ``pose_transfer_tpu/data/device.py``
and of its ``masks_from_polys``.
The host ships uint8 images, (K, 2) keypoints and compact warp/mask
descriptions; heatmaps and part masks are rasterized on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import pose as pose_ops
from ..ops.masks import rasterize_part_masks


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def make_batch_preparer(*, image_size: tuple[int, int], pose_dim: int,
                        device: torch.device | str,
                        use_input_pose: bool = True,
                        warp_skip: str = "mask",
                        dtype: torch.dtype = torch.float32):
    """Build ``prepare(batch) -> dict`` for a fixed config.

    ``batch`` holds numpy arrays or tensors: image_from (N,H,W,3) uint8,
    optional image_to, kp_from/kp_to (N,K,2), warps (N,T,8), mask_polys
    (N,T,4,2), mask_kinds (N,T). Output dict, on ``device``:
      input:  (N, H, W, 3+2K) packed [image ‖ input pose ‖ target pose]
      target: (N, H, W, 3) in [-1, 1] (all -1 without ``image_to``)
      warps:  (N, T, 8)
      masks:  (N, T, H, W) for warp_skip='mask', else None
    """
    device = torch.device(device)

    def prepare(batch: dict) -> dict:
        b = {k: _to_device(v, device) for k, v in batch.items()}
        img_from = pose_ops.preprocess_image(b["image_from"]).to(dtype)
        if "image_to" in b:
            img_to = pose_ops.preprocess_image(b["image_to"]).to(dtype)
        else:
            # serving: no ground-truth target exists; the slot only feeds
            # the (unused) reconstruction target
            img_to = torch.full_like(img_from, -1.0)
        inp_map = pose_ops.cords_to_map(b["kp_from"], image_size).to(dtype)
        tg_map = pose_ops.cords_to_map(b["kp_to"], image_size).to(dtype)
        packed = pose_ops.pack_input(
            img_from, inp_map if use_input_pose else None, tg_map)
        out = {"input": packed, "target": img_to,
               "warps": b["warps"].to(dtype)}
        if warp_skip == "mask":
            out["masks"] = rasterize_part_masks(
                b["mask_polys"], b["mask_kinds"], image_size).to(dtype)
        else:
            out["masks"] = None
        return out

    return prepare


def masks_from_polys(polys: torch.Tensor, kinds: torch.Tensor,
                     image_size: tuple[int, int]) -> torch.Tensor:
    """(N, T, 4, 2) polys + (N, T) kinds → (N, T, H, W) float32 part masks,
    on ``polys``' device (the JAX package's ``masks_from_polys``)."""
    return rasterize_part_masks(polys, kinds, image_size)
