"""The pose-transfer pair dataset (host side) and compact-sample helpers.

Counterpart of ``PoseTransferDataset`` (its baseline branch: the compact
sample and the per-pair warp-fit cache), ``collate`` and ``warp_fit`` in
``pose_transfer_tpu/data/dataset.py``. A sample is compact: uint8 images,
(K, 2) keypoints, (T, 8) affine fits and (T, 4, 2) mask polygons;
heatmaps and part masks are rasterized on the device
(``data.device.make_batch_preparer``).

Kept from the reference, as the JAX package keeps them:
- the ``-interpol`` pair files are read where they exist, else the plain
  ones; in check mode the ``-check`` files, for both;
- train and test annotations are merged into one name-indexed table;
- a *missing* image file becomes a black image. A file that exists but
  does not decode raises (``utils.image_io.read_image``).
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
        if opt["gen_type"] != "baseline":
            raise NotImplementedError(
                f"gen_type={opt['gen_type']!r}: the stacked and U-Net "
                "generators are not ported (ROADMAP.md §A item 7)")
        self.split = split
        self.gen_type = opt["gen_type"]
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
        """Image bytes, keypoints and fits; no rasters."""
        pair = self.pair(index)
        kp_from = self.keypoints(pair["from"])
        kp_to = self.keypoints(pair["to"])
        out = {
            "image_from": self.load_image(pair["from"]),
            "image_to": self.load_image(pair["to"]),
            "kp_from": kp_from.astype(np.float32),
            "kp_to": kp_to.astype(np.float32),
        }
        cached = None if self._warp_cache is None \
            else self._warp_cache.get(index)
        if cached is None:
            cached = warp_fit(kp_from, kp_to, self.pose_dim, self.image_size,
                              self.warp_skip)
            if self._warp_cache is not None:
                self._warp_cache[index] = cached
        warps, polys, kinds = cached
        out.update(warps=warps, mask_polys=polys, mask_kinds=kinds)
        return out

    def __getitem__(self, index: int) -> dict:
        return self.item_compact(index)


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
