"""Keypoint schemas for the two supported skeletons.

Reference: src_deformable/utils/pose_utils.py:19-42 — 16-joint SHG skeleton
(Human3.6M) and 18-joint OpenPose/PAF skeleton (DeepFashion), plus the
``MISSING_VALUE`` sentinel used throughout annotation handling.
"""

from __future__ import annotations

MISSING_VALUE = -1

# 16-joint stacked-hourglass schema (pose_dim == 16, h36m)
LABELS = [
    "Rank", "Rknee", "Rhip", "Lhip", "Lknee", "Lank", "pelv", "spine",
    "neck", "head", "Rwri", "Relb", "Rsho", "Lsho", "Lelb", "Lwri",
]

LIMB_SEQ = [
    [0, 1], [1, 2], [2, 6], [6, 3], [3, 4], [4, 5],
    [10, 11], [11, 12], [12, 8], [8, 13], [13, 14], [14, 15],
    [6, 8], [8, 9],
]

# 18-joint OpenPose/PAF schema (pose_dim == 18, fashion)
LABELS_PAF = [
    "nose", "neck", "Rsho", "Relb", "Rwri", "Lsho", "Lelb", "Lwri",
    "Rhip", "Rkne", "Rank", "Lhip", "Lkne", "Lank", "Leye", "Reye",
    "Lear", "Rear",
]

LIMB_SEQ_PAF = [
    [1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [1, 8], [8, 9],
    [9, 10], [1, 11], [11, 12], [12, 13], [1, 0], [0, 14], [14, 16],
    [0, 15], [15, 17], [2, 16], [5, 17],
]

COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]


def labels_for(pose_dim: int) -> list[str]:
    if pose_dim == 16:
        return LABELS
    if pose_dim == 18:
        return LABELS_PAF
    raise ValueError(f"unsupported pose_dim {pose_dim}")


def limb_seq_for(pose_dim: int) -> list[list[int]]:
    return LIMB_SEQ if pose_dim == 16 else LIMB_SEQ_PAF
