"""The pose-transfer pair dataset (host side) and compact-sample helpers.

Counterpart of ``PoseTransferDataset`` (the compact sample of each
generator type and the per-pair fit cache), ``collate``, ``warp_fit`` and
``interpol_chain`` in ``pose_transfer_tpu/data/dataset.py``. A sample is
compact: uint8 images, (K, 2) keypoints and, for the deformable generator,
(T, 8) affine fits and (T, 4, 2) mask polygons; for the stacked one the
interpolated keypoints and the chain's fits and polygons; for the U-Net
nothing more. Heatmaps and part masks are rasterized on the device
(``data.device.make_batch_preparer``).

Kept from the reference, as the JAX package keeps them:
- the ``-interpol`` pair files are read where they exist, else the plain
  ones; in check mode the ``-check`` files, for both;
- train and test annotations are merged into one name-indexed table;
- a *missing* image file becomes a black image. A file that exists but
  does not decode raises (``utils.image_io.read_image``);
- the stacked chain's poses go through the closed form of the
  reference's heatmap round trip (``annotations.project_keypoints``), and
  its fit list has ``num_stacks + 1`` entries, the first warping the input
  pose onto itself; the stacked generator reads the first ``num_stacks``.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import transforms_host as th
from ..utils.image_io import read_image
from . import annotations as ann
from .pairs import num_rows, read_csv


class PoseTransferDataset:
    """Map-style dataset over (from, to) image pairs.

    Args:
      opt: mapping (or namespace) with the reference's option names (see
        ``cli.opts``).
      split: 'train' | 'test' | 'val'.
      cache_warps: keep each pair's fits after its first use.
    """

    def __init__(self, opt, split: str, cache_warps: bool = True):
        if not isinstance(opt, dict):
            opt = vars(opt)
        self.split = split
        self.gen_type = opt["gen_type"]
        if self.gen_type not in ("baseline", "stacked", "unet"):
            raise ValueError(f"invalid gen_type {self.gen_type!r}")
        self.num_stacks = opt["num_stacks"]
        self.pose_dim = opt["pose_dim"]
        self.image_size = tuple(opt["image_size"])
        self.use_input_pose = bool(opt["use_input_pose"])
        self.warp_skip = opt["warp_skip"]
        # pairs repeat every epoch: their least-squares fits and polygons
        # are kept by index (dict operations are atomic under the GIL)
        self._warp_cache: dict | None = {} if cache_warps else None

        self.images_dir_train = opt["images_dir_train"]
        self.images_dir_test = opt["images_dir_test"]

        def read_pairs(which: str) -> dict:
            if opt.get("checkMode", 0):
                return read_csv(opt[f"pairs_file_{which}_check"])
            interpol = opt[f"pairs_file_{which}_interpol"]
            plain = opt[f"pairs_file_{which}"]
            return read_csv(interpol if os.path.exists(interpol) else plain)

        self._pairs_train = read_pairs("train")
        self._pairs_test = read_pairs("test")
        self._annotations = ann.merge_annotations(
            opt["annotations_file_train"], opt["annotations_file_test"])
        self._kp = {name: ann.load_keypoints(row)
                    for name, row in self._annotations.items()}

        self._pairs = self._pairs_train if split == "train" \
            else self._pairs_test

        print("Statistics for loaded dataset : {}".format(opt["dataset"]))
        print("Number of images: %s" % len(self._annotations))
        print("Number of pairs train: %s" % num_rows(self._pairs_train))
        print("Number of pairs test: %s" % num_rows(self._pairs_test))

    def __len__(self) -> int:
        return num_rows(self._pairs)

    # ---------------------------------------------------------------- host IO

    def pair(self, index: int) -> dict:
        return {"from": self._pairs["from"][index],
                "to": self._pairs["to"][index]}

    def keypoints(self, name: str) -> np.ndarray:
        return self._kp[name]

    def load_image(self, name: str) -> np.ndarray:
        """(H, W, 3) uint8; a black image when the file is missing."""
        for d in (self.images_dir_train, self.images_dir_test):
            path = os.path.join(d, name)
            if os.path.exists(path):
                return read_image(path)
        return np.zeros((*self.image_size, 3), np.uint8)

    # ------------------------------------------------------------- samples

    def item_compact(self, index: int) -> dict:
        """Image bytes, keypoints and the generator type's fits; no
        rasters."""
        pair = self.pair(index)
        kp_from = self.keypoints(pair["from"])
        kp_to = self.keypoints(pair["to"])
        out = {
            "image_from": self.load_image(pair["from"]),
            "image_to": self.load_image(pair["to"]),
            "kp_from": kp_from.astype(np.float32),
            "kp_to": kp_to.astype(np.float32),
        }
        if self.gen_type == "unet":
            return out          # the packed input only
        cached = None if self._warp_cache is None \
            else self._warp_cache.get(index)
        if cached is None:
            if self.gen_type == "stacked":
                cached = interpol_chain(kp_from, kp_to, self.pose_dim,
                                        self.image_size, self.warp_skip,
                                        self.num_stacks)
            else:
                cached = warp_fit(kp_from, kp_to, self.pose_dim,
                                  self.image_size, self.warp_skip)
            if self._warp_cache is not None:
                self._warp_cache[index] = cached
        if self.gen_type == "stacked":
            out.update(zip(("interpol_kp", "interpol_warps",
                            "interpol_polys", "interpol_kinds"), cached))
        else:
            out.update(zip(("warps", "mask_polys", "mask_kinds"), cached))
        return out

    def __getitem__(self, index: int) -> dict:
        return self.item_compact(index)

    def item_reference(self, index: int):
        """The reference's ``__getitem__`` tuple, NCHW float32, built on the
        CPU (for parity tests and goldens).

        baseline: (input, target, warps, masks); stacked: (input, target,
        interpol_pose, interpol_warps, interpol_masks).
        """
        import torch

        from ..core.pose import cords_to_map
        from ..ops.masks import rasterize_part_masks

        pair = self.pair(index)
        kp_from = self.keypoints(pair["from"])
        kp_to = self.keypoints(pair["to"])

        def heat(kp):
            hm = cords_to_map(torch.tensor(kp, dtype=torch.float32),
                              self.image_size).numpy()
            return np.transpose(hm, (2, 0, 1))

        def img(name):
            x = self.load_image(name).astype(np.float32)
            return np.transpose((x / 255.0 - 0.5) * 2.0, (2, 0, 1))

        parts = [img(pair["from"])]
        if self.use_input_pose:
            parts.append(heat(kp_from))
        parts.append(heat(kp_to))
        packed = np.concatenate(parts, axis=0).astype(np.float32)
        target = img(pair["to"])

        if self.gen_type != "stacked":
            if self.warp_skip == "mask":
                warps = th.affine_transforms(kp_from, kp_to, self.pose_dim)
                masks = th.pose_masks(kp_to, self.image_size, self.pose_dim)
            else:
                warps = th.estimate_uniform_transform(kp_from, kp_to,
                                                      self.pose_dim)
                masks = np.ones(1)
            return packed, target, warps, masks

        interpol, warp8, polys, kinds = interpol_chain(
            kp_from, kp_to, self.pose_dim, self.image_size, self.warp_skip,
            self.num_stacks)
        interpol_map = np.concatenate([heat(k) for k in interpol], axis=0)
        masks = np.stack([
            rasterize_part_masks(torch.as_tensor(p), torch.as_tensor(k),
                                 self.image_size).numpy()
            for p, k in zip(polys, kinds)])
        return packed, target, interpol_map, warp8, masks


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


def interpol_chain(kp_from: np.ndarray, kp_to: np.ndarray, pose_dim: int,
                   image_size: tuple[int, int], warp_skip: str,
                   num_stacks: int):
    """The stacked generator's (interpol_kp (S, K, 2), warps (S+1, T, 8),
    polys (S+1, T, 4, 2), kinds (S+1, T)) for one pair: the ``num_stacks``
    interpolated poses of the projected keypoints, and the fits chaining
    pose i-1 → i over [input] + their projections."""
    kp_from_p = ann.project_keypoints(kp_from, image_size)
    kp_to_p = ann.project_keypoints(kp_to, image_size)
    interpol = [ann.interpolate_keypoints_host(kp_from_p, kp_to_p, i,
                                               num_stacks, pose_dim)
                for i in range(1, num_stacks + 1)]
    chain = [kp_from_p] + [ann.project_keypoints(k, image_size)
                           for k in interpol]
    fits = [warp_fit(prev, kp, pose_dim, image_size, warp_skip)
            for prev, kp in zip(chain[:1] + chain[:-1], chain)]
    warps, polys, kinds = (np.stack(f) for f in zip(*fits))
    return np.stack(interpol).astype(np.float32), warps, polys, kinds
