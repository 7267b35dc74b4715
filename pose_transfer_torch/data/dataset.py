"""Compact-sample helpers shared by the server and the synthetic requests.

Counterpart of ``collate`` and ``warp_fit`` in
``pose_transfer_tpu/data/dataset.py``; the file-backed dataset is not
ported yet.
"""

from __future__ import annotations

import numpy as np

from ..core import transforms_host as th


def collate(samples: list[dict]) -> dict:
    """Stack compact samples into one numpy batch dict."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def warp_fit(kp1: np.ndarray, kp2: np.ndarray, pose_dim: int,
             image_size: tuple[int, int], warp_skip: str):
    """(warps, polys, kinds) for one ordered keypoint pair."""
    if warp_skip == "mask":
        warps = th.affine_transforms(kp1, kp2, pose_dim)
        polys, kinds = th.pose_mask_polys(kp2, image_size, pose_dim)
    else:
        warps = th.estimate_uniform_transform(kp1, kp2, pose_dim)[:, :8]
        polys = np.zeros((1, 4, 2), np.float32)
        kinds = np.zeros((1,), np.int32)  # kind 0 = all-ones
    return (warps.astype(np.float32), polys.astype(np.float32),
            kinds.astype(np.int32))
