"""The port's host (numpy) modules against the JAX package's, and the
port's import isolation from JAX.

The port keeps its own copies of the numpy modules it needs; the same rng
state must give equal arrays through both packages.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pose_transfer_tpu.core import skeletons as jsk
from pose_transfer_tpu.core import transforms_host as jth
from pose_transfer_tpu.data import dataset as jds
from pose_transfer_tpu.data import synthetic as jsyn
from pose_transfer_torch.core import skeletons as tsk
from pose_transfer_torch.core import transforms_host as tth
from pose_transfer_torch.data import dataset as tds
from pose_transfer_torch.data import synthetic as tsyn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pairs(pose_dim, n=6, missing_prob=0.0, size=(128, 128)):
    rng = np.random.default_rng(pose_dim)
    return [(jsyn.random_skeleton(rng, size, pose_dim,
                                  missing_prob=missing_prob),
             jsyn.random_skeleton(rng, size, pose_dim,
                                  missing_prob=missing_prob))
            for _ in range(n)]


def test_skeleton_schemas_match():
    for name in ("MISSING_VALUE", "LABELS", "LABELS_PAF", "LIMB_SEQ",
                 "LIMB_SEQ_PAF", "COLORS"):
        assert getattr(tsk, name) == getattr(jsk, name)
    for k in (16, 18):
        assert tsk.labels_for(k) == jsk.labels_for(k)
        assert tth.static_empty_parts(k) == jth.static_empty_parts(k)


@pytest.mark.parametrize("pose_dim,missing_prob",
                         [(18, 0.0), (18, 0.3), (16, 0.0)])
def test_transforms_host_match(pose_dim, missing_prob):
    """Affine fits (with the mirrored-limb fallback and sentinels when
    joints are missing) and mask polygons are equal."""
    size = (128, 128)
    for kp1, kp2 in _pairs(pose_dim, missing_prob=missing_prob, size=size):
        np.testing.assert_array_equal(
            tth.affine_transforms(kp1, kp2, pose_dim),
            jth.affine_transforms(kp1, kp2, pose_dim))
        np.testing.assert_array_equal(
            tth.estimate_uniform_transform(kp1, kp2, pose_dim),
            jth.estimate_uniform_transform(kp1, kp2, pose_dim))
        for a, b in zip(tth.pose_mask_polys(kp2, size, pose_dim),
                        jth.pose_mask_polys(kp2, size, pose_dim)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("warp_skip", ["mask", "full"])
def test_warp_fit_and_collate_match(warp_skip):
    size = (64, 64)
    samples_t, samples_j = [], []
    for kp1, kp2 in _pairs(18, n=3, size=size):
        wt = tds.warp_fit(kp1, kp2, 18, size, warp_skip)
        wj = jds.warp_fit(kp1, kp2, 18, size, warp_skip)
        for a, b in zip(wt, wj):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        samples_t.append({"warps": wt[0], "kp": kp1})
        samples_j.append({"warps": wj[0], "kp": kp1})
    bt, bj = tds.collate(samples_t), jds.collate(samples_j)
    assert bt.keys() == bj.keys()
    for k in bt:
        np.testing.assert_array_equal(bt[k], bj[k])


@pytest.mark.parametrize("warp_skip", ["mask", "full"])
def test_synthetic_batch_matches(warp_skip):
    """Same seed → the same skeletons, images and compact batch."""
    size = (64, 64)
    bt = tsyn.synthetic_compact_batch(np.random.default_rng(5), 3, size, 18,
                                      warp_skip)
    bj = jsyn.synthetic_compact_batch(np.random.default_rng(5), 3, size, 18,
                                      warp_skip)
    assert bt.keys() == bj.keys()
    for k in bt:
        assert bt[k].dtype == bj[k].dtype, k
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    for pose_dim in (16, 18):
        rt, rj = np.random.default_rng(1), np.random.default_rng(1)
        np.testing.assert_array_equal(
            tsyn.random_skeleton(rt, size, pose_dim, missing_prob=0.2),
            jsyn.random_skeleton(rj, size, pose_dim, missing_prob=0.2))
        np.testing.assert_array_equal(tsyn.random_image(rt, size),
                                      jsyn.random_image(rj, size))


def test_port_imports_no_jax():
    """pose_transfer_torch, every submodule and chip_smoke.py import with
    jax, flax and pose_transfer_tpu made unimportable."""
    code = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "pose_transfer_tpu"):
    sys.modules[name] = None
import pose_transfer_torch
mods = [m.name for m in pkgutil.walk_packages(pose_transfer_torch.__path__,
                                              "pose_transfer_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax",
       "pose_transfer_tpu") and sys.modules[m] is not None]
assert not bad, bad
print(len(mods))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15   # every module was walked
