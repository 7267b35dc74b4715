"""The benchmark's own generators of synthetic people, copied from the
program's ``data/synthetic.py`` (same draws from the same numpy
``Generator`` state): plausible skeletons, smooth random images, compact
training batches, and motion jobs (one source, target poses along a path
between two skeletons).

A compact sample carries what the program's loader hands the train step:
uint8 images, (K, 2) keypoints, the 10 part affines and the part-mask
polygons; the fits come from the reference's frozen copy
(``reference/fits.py``), so both sides read the same numbers.
"""

from __future__ import annotations

import numpy as np

from .reference import fits

# canonical upright template, (x, y) in a unit box, per schema
_TEMPLATE_16 = {
    "head": (0.50, 0.08), "neck": (0.50, 0.20), "spine": (0.50, 0.35),
    "pelv": (0.50, 0.52), "Rsho": (0.38, 0.22), "Lsho": (0.62, 0.22),
    "Relb": (0.33, 0.38), "Lelb": (0.67, 0.38), "Rwri": (0.30, 0.52),
    "Lwri": (0.70, 0.52), "Rhip": (0.42, 0.54), "Lhip": (0.58, 0.54),
    "Rknee": (0.41, 0.72), "Lknee": (0.59, 0.72), "Rank": (0.40, 0.92),
    "Lank": (0.60, 0.92),
}
_TEMPLATE_18 = {
    "nose": (0.50, 0.10), "neck": (0.50, 0.22), "Rsho": (0.38, 0.23),
    "Lsho": (0.62, 0.23), "Relb": (0.33, 0.38), "Lelb": (0.67, 0.38),
    "Rwri": (0.30, 0.52), "Lwri": (0.70, 0.52), "Rhip": (0.42, 0.55),
    "Lhip": (0.58, 0.55), "Rkne": (0.41, 0.73), "Lkne": (0.59, 0.73),
    "Rank": (0.40, 0.92), "Lank": (0.60, 0.92), "Reye": (0.46, 0.08),
    "Leye": (0.54, 0.08), "Rear": (0.42, 0.10), "Lear": (0.58, 0.10),
}
# affine fits need hips and shoulders
_PROTECTED = {"Rhip", "Lhip", "Rsho", "Lsho"}


def random_skeleton(rng: np.random.Generator, img_size, pose_dim: int,
                    jitter: float = 0.03,
                    missing_prob: float = 0.0) -> np.ndarray:
    """(K, 2) integer (y, x) keypoints of one plausible person; a joint
    other than hips and shoulders is missing (-1) with ``missing_prob``."""
    h, w = img_size
    labels = fits.LABELS if pose_dim == 16 else fits.LABELS_PAF
    template = _TEMPLATE_16 if pose_dim == 16 else _TEMPLATE_18
    scale = rng.uniform(0.6, 0.9)
    cx = rng.uniform(0.35, 0.65)
    cy = rng.uniform(0.45, 0.55)
    kp = np.zeros((pose_dim, 2), np.int64)
    for i, name in enumerate(labels):
        tx, ty = template[name]
        x = (cx + (tx - 0.5) * scale + rng.normal(0, jitter)) * w
        y = (cy + (ty - 0.5) * scale + rng.normal(0, jitter)) * h
        if name not in _PROTECTED and rng.random() < missing_prob:
            kp[i] = (-1, -1)
        else:
            kp[i] = (int(np.clip(y, 0, h - 1)), int(np.clip(x, 0, w - 1)))
    return kp


def random_image(rng: np.random.Generator, img_size) -> np.ndarray:
    """(H, W, 3) uint8 smooth random image (8 × 8 blocks)."""
    h, w = img_size
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
    return np.kron(small, np.ones((8, 8, 1), np.uint8))[:h, :w]


def compact_sample(rng, img_size, pose_dim: int,
                   missing_prob: float = 0.0) -> dict:
    """One training sample: two people, two images, their fits."""
    kp_from = random_skeleton(rng, img_size, pose_dim,
                              missing_prob=missing_prob)
    kp_to = random_skeleton(rng, img_size, pose_dim,
                            missing_prob=missing_prob)
    warps, polys, kinds = fits.fit(kp_from, kp_to, pose_dim, img_size)
    return {"image_from": random_image(rng, img_size),
            "image_to": random_image(rng, img_size),
            "kp_from": kp_from.astype(np.float32),
            "kp_to": kp_to.astype(np.float32),
            "warps": warps, "mask_polys": polys, "mask_kinds": kinds}


def compact_batch(rng, batch: int, img_size, pose_dim: int,
                  missing_prob: float = 0.0) -> dict:
    """``batch`` samples stacked key by key."""
    samples = [compact_sample(rng, img_size, pose_dim, missing_prob)
               for _ in range(batch)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def request(rng, img_size, pose_dim: int, missing_prob: float = 0.0):
    """One serving request: (image, kp_from, kp_to)."""
    kp_from = random_skeleton(rng, img_size, pose_dim,
                              missing_prob=missing_prob)
    kp_to = random_skeleton(rng, img_size, pose_dim,
                            missing_prob=missing_prob)
    return (random_image(rng, img_size), kp_from.astype(np.float32),
            kp_to.astype(np.float32))


def motion_job(rng, img_size, pose_dim: int, frames: int) -> list:
    """One motion-transfer job: a source image and its keypoints, and
    ``frames`` target poses interpolated from one skeleton to another;
    every frame a request (image, kp_from, kp_to) sharing the source."""
    image = random_image(rng, img_size)
    kp_from = random_skeleton(rng, img_size, pose_dim).astype(np.float32)
    a = random_skeleton(rng, img_size, pose_dim).astype(np.float32)
    b = random_skeleton(rng, img_size, pose_dim).astype(np.float32)
    steps = np.linspace(0.0, 1.0, frames, dtype=np.float32)
    return [(image, kp_from, np.round(a + (b - a) * s)) for s in steps]
