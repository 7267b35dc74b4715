"""Auxiliary pose utilities: a morphological person mask, missing-value
imputation and the joint-colour legend.

Counterpart of ``pose_transfer_tpu/utils/misc.py`` (the reference's
``pose_utils.py`` helpers), in numpy: the polygons rasterized by
``core.transforms_host.grid_points_in_poly``, the closing by scipy's binary
dilation and erosion, the legend by matplotlib (both imported when
called).
"""

from __future__ import annotations

import numpy as np

from ..core.skeletons import COLORS, LABELS, MISSING_VALUE
from ..core.transforms_host import grid_points_in_poly
from .visualize import disk

# the morphological mask's limbs (the reference's), 1-indexed OpenPose
_MA_LIMBS = np.array(
    [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
     [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
     [1, 16], [16, 18], [2, 17], [2, 18], [9, 12], [12, 6], [9, 3],
     [17, 18]]) - 1


def mean_inputation(x: np.ndarray) -> np.ndarray:
    """Replace MISSING_VALUE entries with the per-position mean over
    axis 0."""
    x = np.asarray(x, dtype=np.float64).copy()
    missing = x == MISSING_VALUE
    with np.errstate(invalid="ignore"):
        means = np.where(missing, np.nan, x)
        means = np.nanmean(means, axis=0, keepdims=True)
    return np.where(missing, np.broadcast_to(means, x.shape), x)


def produce_ma_mask(kp_array: np.ndarray, img_size: tuple[int, int],
                    point_radius: int = 4) -> np.ndarray:
    """Morphological person mask from OpenPose keypoints: thick limb quads
    and joint disks, closed with a 5x5 square dilation and erosion."""
    from scipy.ndimage import binary_dilation, binary_erosion

    kp_array = np.asarray(kp_array)
    mask = np.zeros(img_size, bool)
    for f, t in _MA_LIMBS:
        if (kp_array[f][0] == MISSING_VALUE or kp_array[f][1] == MISSING_VALUE
                or kp_array[t][0] == MISSING_VALUE
                or kp_array[t][1] == MISSING_VALUE):
            continue
        norm_vec = kp_array[f] - kp_array[t]
        norm_vec = np.array([-norm_vec[1], norm_vec[0]], np.float64)
        n = np.linalg.norm(norm_vec)
        if n == 0:
            continue
        norm_vec = point_radius * norm_vec / n
        verts = np.array([kp_array[f] + norm_vec, kp_array[f] - norm_vec,
                          kp_array[t] - norm_vec, kp_array[t] + norm_vec])
        mask |= grid_points_in_poly(img_size, verts)

    for joint in kp_array:
        if joint[0] == MISSING_VALUE or joint[1] == MISSING_VALUE:
            continue
        yy, xx = disk(joint[0], joint[1], point_radius, img_size)
        mask[yy, xx] = True

    footprint = np.ones((5, 5), bool)
    mask = binary_dilation(mask, footprint)
    mask = binary_erosion(mask, footprint)
    return mask


def draw_legend(ax=None):
    """Joint-colour legend on ``ax`` (or the current figure)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    handles = [mpatches.Patch(color=np.array(color) / 255.0, label=name)
               for color, name in zip(COLORS, LABELS)]
    (ax or plt).legend(handles=handles, bbox_to_anchor=(1.05, 1), loc=2,
                       borderaxespad=0.0)
