"""Host fits of the plain reference: the per-pair inverse part affines and
the compact part-mask polygons, in NumPy.

A frozen copy of the deformable GAN's host estimation (the reference's
``utils/pose_transform.py`` as the port restates it without skimage): the
10 inverse (output → input) part affines (body, head, 8 limb segments,
with the mirrored-limb fallback and the translation-by-1000 sentinel) and
the part-mask polygons of the target pose (body all ones, head box, limb
quads, empty). Copied so that the reference imports nothing of the
program; the program computes its own fits, and the comparison sees any
change to them.
"""

from __future__ import annotations

import numpy as np

MISSING_VALUE = -1

# 16-joint stacked-hourglass schema (pose_dim == 16, h36m)
LABELS = [
    "Rank", "Rknee", "Rhip", "Lhip", "Lknee", "Lank", "pelv", "spine",
    "neck", "head", "Rwri", "Relb", "Rsho", "Lsho", "Lelb", "Lwri",
]

# 18-joint OpenPose/PAF schema (pose_dim == 18, fashion)
LABELS_PAF = [
    "nose", "neck", "Rsho", "Relb", "Rwri", "Lsho", "Lelb", "Lwri",
    "Rhip", "Rkne", "Rank", "Lhip", "Lkne", "Lank", "Leye", "Reye",
    "Lear", "Rear",
]

NO_POINT_TR = np.array([[1.0, 0.0, 1000.0],
                        [0.0, 1.0, 1000.0],
                        [0.0, 0.0, 1.0]])

HEAD_CANDIDATE_NAMES = ("Leye", "Reye", "Lear", "Rear", "nose")

# (from, to, inc_to for transforms, inc_to for masks) per limb part, in the
# reference's ordering. Transforms use inc_to 0.3 for lower segments while
# masks use 0.5 — reference asymmetry.
LIMB_PARTS = (
    ("Rhip", "Rkne", 0.1, 0.1),
    ("Lhip", "Lkne", 0.1, 0.1),
    ("Rkne", "Rank", 0.3, 0.5),
    ("Lkne", "Lank", 0.3, 0.5),
    ("Rsho", "Relb", 0.1, 0.1),
    ("Lsho", "Lelb", 0.1, 0.1),
    ("Relb", "Rwri", 0.3, 0.5),
    ("Lelb", "Lwri", 0.3, 0.5),
)

NUM_PARTS = 2 + len(LIMB_PARTS)  # body + head + 8 limb segments


def give_name_to_keypoints(array: np.ndarray, pose_dim: int) -> dict:
    """(K, 2) (y, x) array → {joint name: (x, y)} skipping missing joints."""
    labels = LABELS if pose_dim == 16 else LABELS_PAF
    res = {}
    for i, name in enumerate(labels):
        if array[i][0] != MISSING_VALUE and array[i][1] != MISSING_VALUE:
            res[name] = np.asarray(array[i][::-1], dtype=np.float64)
    return res


def check_keypoints_present(kp: dict, names) -> bool:
    return all(name in kp for name in names)


def compute_st_distance(kp: dict) -> float:
    """Torso scale: RMS of hip-shoulder distances."""
    d1 = np.sum((kp["Rhip"] - kp["Rsho"]) ** 2)
    d2 = np.sum((kp["Lhip"] - kp["Lsho"]) ** 2)
    return float(np.sqrt((d1 + d2) / 2.0))


def estimate_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares 2D affine mapping src→dst; returns 3x3 params matrix
    (minimizes ||X @ M.T - dst|| with X = [x, y, 1])."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    n = src.shape[0]
    x = np.concatenate([src, np.ones((n, 1))], axis=1)
    sol, *_ = np.linalg.lstsq(x, dst, rcond=None)
    params = np.eye(3)
    params[:2, :] = sol.T
    return params


def estimate_polygon(fr: np.ndarray, to: np.ndarray, st: float, inc_to: float,
                     inc_from: float, p_to: float, p_from: float) -> np.ndarray:
    """Quadrilateral around a limb segment.

    Note the sequential update: ``to`` is extended using the already-extended
    ``fr`` — the reference does this and the polygon shape depends on it.
    """
    fr = fr + (fr - to) * inc_from
    to = to + (to - fr) * inc_to
    norm_vec = fr - to
    norm_vec = np.array([-norm_vec[1], norm_vec[0]])
    norm = np.linalg.norm(norm_vec)
    if norm == 0:
        return np.array([fr + 1, fr - 1, to - 1, to + 1])
    norm_vec = norm_vec / norm
    return np.array([
        fr + st * p_from * norm_vec,
        fr - st * p_from * norm_vec,
        to - st * p_to * norm_vec,
        to + st * p_to * norm_vec,
    ])


def _to_transform(tr: np.ndarray) -> np.ndarray:
    """Keep ``tr`` if invertible else the sentinel."""
    try:
        np.linalg.inv(tr)
        return tr
    except np.linalg.LinAlgError:
        return NO_POINT_TR


def affine_transforms(array1: np.ndarray, array2: np.ndarray,
                      pose_dim: int) -> np.ndarray:
    """Estimate the 10 inverse (output→input) part affines → (10, 8).

    Parts in order: body, head, then LIMB_PARTS, with the mirrored-limb
    fallback.
    """
    kp1 = give_name_to_keypoints(array1, pose_dim)
    kp2 = give_name_to_keypoints(array2, pose_dim)
    st1 = compute_st_distance(kp1)
    st2 = compute_st_distance(kp2)

    transforms = []

    body_names = ["Rhip", "Lhip", "Lsho", "Rsho"]
    body_poly_1 = np.array([kp1[n] for n in body_names])
    body_poly_2 = np.array([kp2[n] for n in body_names])
    transforms.append(_to_transform(estimate_affine(src=body_poly_2,
                                                    dst=body_poly_1)))

    head_names = {n for n in HEAD_CANDIDATE_NAMES if n in kp1 and n in kp2}
    if head_names:
        head_names |= {"Lsho", "Rsho"}
        names = list(head_names)
        head_poly_1 = np.array([kp1[n] for n in names])
        head_poly_2 = np.array([kp2[n] for n in names])
        transforms.append(_to_transform(estimate_affine(src=head_poly_2,
                                                        dst=head_poly_1)))
    else:
        transforms.append(_to_transform(NO_POINT_TR))

    def estimate_join(fr: str, to: str, inc_to: float) -> np.ndarray:
        if not check_keypoints_present(kp2, [fr, to]):
            return NO_POINT_TR
        poly_2 = estimate_polygon(kp2[fr], kp2[to], st2, inc_to, 0.1, 0.2, 0.2)
        if check_keypoints_present(kp1, [fr, to]):
            poly_1 = estimate_polygon(kp1[fr], kp1[to], st1, inc_to, 0.1, 0.2, 0.2)
        else:
            # mirrored-side fallback
            if fr[0] == "R":
                fr, to = fr.replace("R", "L"), to.replace("R", "L")
            else:
                fr, to = fr.replace("L", "R"), to.replace("L", "R")
            if check_keypoints_present(kp1, [fr, to]):
                poly_1 = estimate_polygon(kp1[fr], kp1[to], st1, inc_to,
                                          0.1, 0.2, 0.2)
            else:
                return NO_POINT_TR
        return estimate_affine(src=poly_2, dst=poly_1)

    for fr, to, inc_to, _ in LIMB_PARTS:
        transforms.append(_to_transform(estimate_join(fr, to, inc_to)))

    return np.array(transforms).reshape((-1, 9))[..., :-1]


def pose_mask_polys(array2: np.ndarray, img_size: tuple[int, int],
                    pose_dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Compact mask description for device-side rasterization.

    Returns:
      polys: (10, 4, 2) float32 polygon vertices in (y, x) pixel space.
      kinds: (10,) int32 — 0: all-ones (body), 1: box (head, verts are the
        box corners), 2: even-odd quad (limbs), 3: empty.
    ``ops.masks.rasterize_part_masks`` turns this into (10, H, W) masks.
    """
    kp2 = give_name_to_keypoints(array2, pose_dim)
    st2 = compute_st_distance(kp2)
    polys = np.zeros((NUM_PARTS, 4, 2), dtype=np.float32)
    kinds = np.zeros((NUM_PARTS,), dtype=np.int32)

    kinds[0] = 0  # body: all ones

    head_names = [n for n in HEAD_CANDIDATE_NAMES if n in kp2]
    if head_names:
        com = np.mean([kp2[n] for n in head_names], axis=0,
                      keepdims=True).astype(int)
        mn = np.maximum(np.min(com, axis=0) - int(0.40 * st2), 0)
        mx = np.minimum(np.max(com, axis=0) + int(0.40 * st2),
                        np.asarray(img_size)[::-1])
        # store box corners (y, x): rows [mn_y, mx_y), cols [mn_x, mx_x)
        polys[1, 0] = (mn[1], mn[0])
        polys[1, 1] = (mx[1], mx[0])
        kinds[1] = 1
    else:
        kinds[1] = 3

    for j, (fr, to, _, inc_to) in enumerate(LIMB_PARTS):
        i = 2 + j
        if not check_keypoints_present(kp2, [fr, to]):
            kinds[i] = 3
            continue
        poly = estimate_polygon(kp2[fr], kp2[to], st2, inc_to, 0.1, 0.2, 0.2)
        polys[i] = poly[:, ::-1]  # (x, y) → (y, x)
        kinds[i] = 2

    return polys, kinds


def fit(kp_from: np.ndarray, kp_to: np.ndarray, pose_dim: int,
        image_size: tuple[int, int]):
    """(warps (10, 8) float32, polys (10, 4, 2) float32, kinds (10,) int32)
    of one ordered keypoint pair, as a compact sample carries them."""
    polys, kinds = pose_mask_polys(kp_to, image_size, pose_dim)
    return (affine_transforms(kp_from, kp_to, pose_dim).astype(np.float32),
            polys.astype(np.float32), kinds.astype(np.int32))
