"""Synthetic people: random plausible skeletons and images, in memory and
as an on-disk dataset.

Counterpart of ``random_skeleton``, ``random_image``, ``skeleton_image``,
``write_synthetic_dataset`` and the baseline branch of
``synthetic_compact_batch`` in ``pose_transfer_tpu/data/synthetic.py``.
The same numpy ``Generator`` state gives the same arrays as the JAX
package's functions, so tests feed both packages from one seed.

``write_synthetic_dataset`` writes the JAX writer's directory layout,
annotation rows and pair files from the same draws, but saves the images
as lossless ``.png`` files (``utils.image_io``) where the JAX writer saves
JPEG: the card's installation has no JPEG codec, and a PNG decodes to
exactly the drawn pixels.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import transforms_host as th
from ..core.skeletons import LABELS, LABELS_PAF
from ..utils.image_io import write_png
from .annotations import dump_keypoints, write_annotations
from .pairs import build_pairs, write_csv

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


def random_skeleton(rng: np.random.Generator, img_size: tuple[int, int],
                    pose_dim: int, jitter: float = 0.03,
                    missing_prob: float = 0.0) -> np.ndarray:
    """(K, 2) integer (y, x) keypoints for one plausible person."""
    h, w = img_size
    labels = LABELS if pose_dim == 16 else LABELS_PAF
    template = _TEMPLATE_16 if pose_dim == 16 else _TEMPLATE_18
    scale = rng.uniform(0.6, 0.9)
    cx = rng.uniform(0.35, 0.65)
    cy = rng.uniform(0.45, 0.55)
    kp = np.zeros((pose_dim, 2), np.int64)
    # torso joints must survive: affine fits need hips+shoulders present
    protected = {"Rhip", "Lhip", "Rsho", "Lsho"}
    for i, name in enumerate(labels):
        tx, ty = template[name]
        x = (cx + (tx - 0.5) * scale + rng.normal(0, jitter)) * w
        y = (cy + (ty - 0.5) * scale + rng.normal(0, jitter)) * h
        if name not in protected and rng.random() < missing_prob:
            kp[i] = (-1, -1)
        else:
            kp[i] = (int(np.clip(y, 0, h - 1)), int(np.clip(x, 0, w - 1)))
    return kp


def random_image(rng: np.random.Generator,
                 img_size: tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 smooth random image."""
    h, w = img_size
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
    return np.kron(small, np.ones((8, 8, 1), np.uint8))[:h, :w]


def skeleton_image(kp: np.ndarray, img_size: tuple[int, int],
                   pose_dim: int) -> np.ndarray:
    """(H, W, 3) uint8 rendering of the skeleton itself: an image that is a
    function of its pose, so that pose transfer is learnable."""
    from ..utils.visualize import draw_pose_from_cords

    radius = max(2, min(img_size) // 32)
    colors, _ = draw_pose_from_cords(kp, pose_dim, img_size, radius=radius)
    return colors


def synthetic_compact_batch(rng: np.random.Generator, batch_size: int,
                            img_size: tuple[int, int], pose_dim: int,
                            warp_skip: str = "mask") -> dict:
    """In-memory compact batch for the baseline generator."""
    samples = []
    for _ in range(batch_size):
        kp_from = random_skeleton(rng, img_size, pose_dim)
        kp_to = random_skeleton(rng, img_size, pose_dim)
        s = {
            "image_from": random_image(rng, img_size),
            "image_to": random_image(rng, img_size),
            "kp_from": kp_from.astype(np.float32),
            "kp_to": kp_to.astype(np.float32),
        }
        if warp_skip == "mask":
            s["warps"] = th.affine_transforms(
                kp_from, kp_to, pose_dim).astype(np.float32)
            polys, kinds = th.pose_mask_polys(kp_to, img_size, pose_dim)
            s["mask_polys"], s["mask_kinds"] = polys, kinds
        else:
            s["warps"] = th.estimate_uniform_transform(
                kp_from, kp_to, pose_dim)[:, :8].astype(np.float32)
            s["mask_polys"] = np.zeros((1, 4, 2), np.float32)
            s["mask_kinds"] = np.zeros((1,), np.int32)
        samples.append(s)
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def write_synthetic_dataset(data_dir: str, dataset: str = "fasion",
                            pose_dim: int = 18, num_people: int = 4,
                            images_per_person: int = 3,
                            img_size: tuple[int, int] = (256, 256),
                            seed: int = 0,
                            style: str = "noise") -> None:
    """Write a complete on-disk synthetic dataset in the reference layout:

      <data_dir>/<dataset>-dataset/{train,test}/  (PNG images)
      <data_dir>/<dataset>-annotation-{train,test}.csv   (sep=':')
      <data_dir>/<dataset>-pairs-{train,test}.csv (+ -interpol/-check twins)
    """
    rng = np.random.default_rng(seed)
    for split in ("train", "test"):
        img_dir = os.path.join(data_dir, f"{dataset}-dataset", split)
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for p in range(num_people):
            for i in range(images_per_person):
                name = f"{split}p{p:03d}_{i:04d}.png"
                kp = random_skeleton(rng, img_size, pose_dim)
                img = skeleton_image(kp, img_size, pose_dim) \
                    if style == "skeleton" else random_image(rng, img_size)
                write_png(os.path.join(img_dir, name), img)
                rows.append((name, *dump_keypoints(kp)))
        write_annotations(os.path.join(
            data_dir, f"{dataset}-annotation-{split}.csv"), rows)
        pairs = build_pairs([r[0] for r in rows], pose_dim)
        # -check twins too: a check-mode dataset reads only those
        for suffix in ("", "-interpol", "-check"):
            write_csv(pairs, os.path.join(
                data_dir, f"{dataset}-pairs-{split}{suffix}.csv"))
