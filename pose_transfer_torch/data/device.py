"""Device-side batch preparation: compact host batch → model-ready tensors.

Counterpart of ``pose_transfer_tpu/data/device.py``: the preparer of each
generator type, and ``masks_from_polys``.
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
                        gen_type: str = "baseline",
                        num_stacks: int = 4,
                        dtype: torch.dtype = torch.float32):
    """Build ``prepare(batch) -> dict`` for a fixed config.

    ``batch`` holds numpy arrays or tensors: image_from (N,H,W,3) uint8,
    optional image_to, kp_from/kp_to (N,K,2), and the generator type's
    fits: warps (N,T,8), mask_polys (N,T,4,2), mask_kinds (N,T)
    (baseline); interpol_kp (N,S,K,2), interpol_warps (N,S+1,T,8),
    interpol_polys (N,S+1,T,4,2), interpol_kinds (N,S+1,T) (stacked);
    none (unet). Output dict, on ``device``:
      input:  (N, H, W, 3+2K) packed [image ‖ input pose ‖ target pose]
      target: (N, H, W, 3) in [-1, 1] (all -1 without ``image_to``)
    and for baseline
      warps:  (N, T, 8)
      masks:  (N, T, H, W) for warp_skip='mask', else None
    or for stacked
      interpol_pose:  (N, H, W, S·K) the stages' heatmaps, stage-major
      interpol_warps: (N, S+1, T, 8)
      interpol_masks: (N, S+1, T, H, W) for warp_skip='mask', else None.
    """
    device = torch.device(device)
    h, w = image_size

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
        out = {"input": packed, "target": img_to}
        if gen_type == "unet":
            return out                  # the packed input only
        if gen_type == "stacked":
            kp = b["interpol_kp"]
            n = kp.shape[0]
            # (N, S, H, W, K) → (N, H, W, S·K)
            maps = pose_ops.cords_to_map(kp, image_size)
            out["interpol_pose"] = maps.permute(0, 2, 3, 1, 4).reshape(
                n, h, w, num_stacks * pose_dim).to(dtype)
            out["interpol_warps"] = b["interpol_warps"].to(dtype)
            if warp_skip == "mask":
                kinds = b["interpol_kinds"]
                s1, t = kinds.shape[1:]
                masks = rasterize_part_masks(
                    b["interpol_polys"].reshape(n * s1, t, 4, 2),
                    kinds.reshape(n * s1, t), image_size)
                out["interpol_masks"] = masks.reshape(
                    n, s1, t, h, w).to(dtype)
            else:
                out["interpol_masks"] = None
            return out
        out["warps"] = b["warps"].to(dtype)
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
