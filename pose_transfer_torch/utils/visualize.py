"""Sample grids: skeleton rendering, tiling and the train-loop display.

Counterpart of ``pose_transfer_tpu/utils/visualize.py`` (its baseline
half), in numpy. Arrays are NHWC; a tensor argument (on any device, any
float dtype) is read as float32 numpy first. ``save_image`` writes PNG
through ``utils.image_io``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.skeletons import COLORS, LIMB_SEQ, LIMB_SEQ_PAF, MISSING_VALUE
from .image_io import write_png


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def line_aa(y0: int, x0: int, y1: int, x1: int):
    """Anti-aliased line (Wu's algorithm): (yy, xx, val) index/weight
    triples, the contract of ``skimage.draw.line_aa``."""
    y0, x0, y1, x1 = float(y0), float(x0), float(y1), float(x1)
    steep = abs(y1 - y0) > abs(x1 - x0)
    if steep:
        x0, y0, x1, y1 = y0, x0, y1, x1
    if x0 > x1:
        x0, x1, y0, y1 = x1, x0, y1, y0
    dx = x1 - x0
    grad = (y1 - y0) / dx if dx != 0 else 1.0

    xs = np.arange(int(round(x0)), int(round(x1)) + 1)
    ys = y0 + grad * (xs - x0)
    floor = np.floor(ys)
    frac = ys - floor
    yy = np.concatenate([floor, floor + 1]).astype(np.int64)
    xx = np.concatenate([xs, xs]).astype(np.int64)
    val = np.concatenate([1.0 - frac, frac])
    keep = val > 1e-6
    yy, xx, val = yy[keep], xx[keep], val[keep]
    if steep:
        yy, xx = xx, yy
    return yy, xx, val


def disk(y: int, x: int, radius: int, shape: tuple[int, int]):
    """Filled circle pixel indices clipped to ``shape``."""
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    inside = yy ** 2 + xx ** 2 <= radius ** 2
    yy = yy[inside] + int(y)
    xx = xx[inside] + int(x)
    keep = (yy >= 0) & (yy < shape[0]) & (xx >= 0) & (xx < shape[1])
    return yy[keep], xx[keep]


def draw_pose_from_cords(pose_joints: np.ndarray, pose_dim: int,
                         img_size: tuple[int, int], radius: int = 2,
                         draw_joints: bool = True):
    """Render a skeleton: white anti-aliased limbs and a coloured disk per
    joint. Returns (colors uint8 HWC, bool mask)."""
    pose_joints = np.asarray(pose_joints)
    colors = np.zeros((*img_size, 3), np.uint8)
    mask = np.zeros(img_size, bool)
    limb_seq = LIMB_SEQ if pose_dim == 16 else LIMB_SEQ_PAF

    def missing(j):
        return (pose_joints[j][0] == MISSING_VALUE or
                pose_joints[j][1] == MISSING_VALUE)

    if draw_joints:
        for f, t in limb_seq:
            if missing(f) or missing(t):
                continue
            yy, xx, val = line_aa(pose_joints[f][0], pose_joints[f][1],
                                  pose_joints[t][0], pose_joints[t][1])
            keep = (yy >= 0) & (yy < img_size[0]) & \
                   (xx >= 0) & (xx < img_size[1])
            yy, xx, val = yy[keep], xx[keep], val[keep]
            colors[yy, xx] = np.expand_dims(val, 1) * 255
            mask[yy, xx] = True

    for i, joint in enumerate(pose_joints):
        if missing(i):
            continue
        yy, xx = disk(joint[0], joint[1], radius, img_size)
        colors[yy, xx] = COLORS[i % len(COLORS)]
        mask[yy, xx] = True
    return colors, mask


def map_to_cord(pose_map: np.ndarray, pose_dim: int,
                threshold: float = 0.1) -> np.ndarray:
    """(H, W, K) heatmaps → (K, 2) int32 (y, x): per channel the first
    row-major location of its max where that max exceeds ``threshold``,
    else MISSING_VALUE."""
    pose_map = np.asarray(pose_map)[..., :pose_dim]
    h, w = pose_map.shape[:2]
    flat = np.moveaxis(pose_map, -1, 0).reshape(pose_dim, h * w)
    idx = np.argmax(flat, axis=-1)
    valid = flat[np.arange(pose_dim), idx] > threshold
    y = np.where(valid, idx // w, MISSING_VALUE)
    x = np.where(valid, idx % w, MISSING_VALUE)
    return np.stack([y, x], axis=-1).astype(np.int32)


def draw_pose_from_map(pose_map, pose_dim: int, threshold: float = 0.1,
                       **kwargs):
    """(H, W, K) heatmaps → rendered skeleton."""
    pose_map = _np(pose_map)
    cords = map_to_cord(pose_map, pose_dim, threshold=threshold)
    return draw_pose_from_cords(cords, pose_dim, pose_map.shape[:2],
                                **kwargs)


def make_grid(batch, row: int, col: int, order: int = 0) -> np.ndarray:
    """Tile an (N, H, W, C) batch into a (row·H, col·W, C) canvas (order 0
    fills columns first)."""
    batch = _np(batch)
    n, h, w, c = batch.shape
    out = np.empty((row * h, col * w, c), batch.dtype)
    idx = 0
    outer, inner = (col, row) if order == 0 else (row, col)
    for i in range(outer):
        for j in range(inner):
            r, cidx = (j, i) if order == 0 else (i, j)
            out[r * h:(r + 1) * h, cidx * w:(cidx + 1) * w] = batch[idx]
            idx += 1
    return out


def _to_uint8(img) -> np.ndarray:
    """[-1, 1] float NHWC → uint8."""
    img = _np(img).astype(np.float32)
    return (255.0 * (img + 1.0) / 2.0).clip(0, 255).astype(np.uint8)


def display(input_batch, target_batch, output_batch, use_input_pose: bool,
            pose_dim: int) -> np.ndarray:
    """The train-loop sample grid: columns [input image | target-pose
    skeleton | target | generated], one row per sample. NHWC inputs."""
    input_batch = _np(input_batch)
    row = input_batch.shape[0]
    k = pose_dim
    inp_img = input_batch[..., :3]
    tg_pose = input_batch[..., (3 + k if use_input_pose else 3):]

    pose_images = np.array([draw_pose_from_map(p, pose_dim)[0]
                            for p in tg_pose])
    cols = [make_grid(_to_uint8(inp_img), row, 1),
            make_grid(pose_images, row, 1),
            make_grid(_to_uint8(target_batch), row, 1),
            make_grid(_to_uint8(output_batch), row, 1)]
    return np.concatenate(cols, axis=1)


def save_image(path: str, image) -> None:
    """Write a uint8 HWC image as PNG."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: the port writes PNG files only")
    write_png(path, _np(image))
