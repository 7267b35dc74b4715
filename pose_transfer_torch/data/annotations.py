"""Annotation files and host-side keypoint bookkeeping.

Counterpart of ``pose_transfer_tpu/data/annotations.py``, on the standard
library's ``csv`` module instead of pandas. The annotation files are
``:``-separated CSVs with the columns ``name:keypoints_y:keypoints_x``,
whose keypoint columns hold JSON lists. A table is a name-indexed mapping
``{name: {"keypoints_y": str, "keypoints_x": str}}`` in file order; where a
name repeats, the later row wins, as the JAX dataset's keypoint lookup
does.
"""

from __future__ import annotations

import csv
import json

import numpy as np

from ..core.skeletons import MISSING_VALUE

COLUMNS = ("name", "keypoints_y", "keypoints_x")


def _read_rows(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter=":"))


def load_annotations(path: str) -> dict[str, dict]:
    """Read one annotation CSV, indexed by image name."""
    return {row["name"]: {k: v for k, v in row.items() if k != "name"}
            for row in _read_rows(path)}


def merge_annotations(train_path: str, test_path: str) -> dict[str, dict]:
    """Train then test annotations in one name-indexed mapping."""
    merged = load_annotations(train_path)
    merged.update(load_annotations(test_path))
    return merged


def write_annotations(path: str, rows) -> None:
    """Write ``(name, keypoints_y, keypoints_x)`` rows as pandas'
    ``to_csv(sep=":", index=False)`` writes them."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=":", lineterminator="\n")
        w.writerow(COLUMNS)
        w.writerows(rows)


def load_keypoints(row) -> np.ndarray:
    """Annotation row → (K, 2) int array of (y, x) keypoints."""
    y = np.asarray(json.loads(row["keypoints_y"]))
    x = np.asarray(json.loads(row["keypoints_x"]))
    return np.stack([y, x], axis=1)


def dump_keypoints(kp: np.ndarray) -> tuple[str, str]:
    """(K, 2) (y, x) keypoints → (keypoints_y, keypoints_x) JSON strings."""
    kp = np.asarray(kp)
    return (json.dumps([int(v) for v in kp[:, 0]]),
            json.dumps([int(v) for v in kp[:, 1]]))


def project_keypoints(cords: np.ndarray,
                      img_size: tuple[int, int],
                      sigma: float = 6.0,
                      threshold: float = 0.1) -> np.ndarray:
    """Closed form of ``map_to_cord(cords_to_map(kp))``: each coordinate
    snaps to the nearest grid point (ties to the smaller index), clamped
    into the image; the joint goes missing where the peak Gaussian value
    does not exceed ``threshold``."""
    cords = np.asarray(cords, dtype=np.float64)
    h, w = img_size
    missing = (cords[:, 0] == MISSING_VALUE) | (cords[:, 1] == MISSING_VALUE)
    py = np.clip(np.ceil(cords[:, 0] - 0.5), 0, h - 1)
    px = np.clip(np.ceil(cords[:, 1] - 0.5), 0, w - 1)
    d2 = (py - cords[:, 0]) ** 2 + (px - cords[:, 1]) ** 2
    peak = np.exp(-d2 / (2.0 * sigma ** 2))
    valid = ~missing & (peak > threshold)
    out = np.full_like(cords, MISSING_VALUE)
    out[valid, 0] = py[valid]
    out[valid, 1] = px[valid]
    return out.astype(np.int64)


def interpolate_keypoints_host(kp_from: np.ndarray, kp_to: np.ndarray,
                               index: int, num_stacks: int,
                               pose_dim: int) -> np.ndarray:
    """Keypoints ``index / num_stacks`` of the way from ``kp_from`` to
    ``kp_to``: a plain lerp for pose_dim 16; for pose_dim 18 a joint
    missing on one side appears or vanishes at the halfway stack."""
    kp_from = np.asarray(kp_from, dtype=np.float64)
    kp_to = np.asarray(kp_to, dtype=np.float64)
    frac = index / num_stacks
    lerp = kp_from + (kp_to - kp_from) * frac
    if pose_dim == 16:
        return lerp

    inp_missing = np.any(kp_from == MISSING_VALUE, axis=-1)
    tg_missing = np.any(kp_to == MISSING_VALUE, axis=-1)
    first_half = index <= num_stacks // 2
    out = lerp.copy()
    only_inp = inp_missing & ~tg_missing
    only_tg = tg_missing & ~inp_missing
    both = inp_missing & tg_missing
    out[only_inp] = MISSING_VALUE if first_half else kp_to[only_inp]
    out[only_tg] = kp_from[only_tg] if first_half else MISSING_VALUE
    out[both] = MISSING_VALUE
    return out
