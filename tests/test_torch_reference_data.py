"""The host-side reference data of the port against the JAX package's: the
host half of ``core.transforms_host``, ``PoseTransferDataset.
item_reference``, the Keras importer (on ``.h5`` files written here with
h5py), ``utils.misc`` and ``data.h36m_preproc``.

Every comparison is exact (numpy on both sides, the same draws), except:
- ``item_reference``'s heatmaps: the port's torch ``cords_to_map`` and
  JAX's jitted one round the Gaussian's exponent differently, within 2e-7
  (as the preparers in ``tests/test_torch_stacked.py``);
- ``h36m_preproc``'s resize: a numpy counterpart of ``cv2.resize``'s uint8
  INTER_LINEAR (its 11-bit fixed-point weights and vector rounding), equal
  to cv2's bytes on the downscales the H36M crops take, and within one
  level on an upscale, where cv2's scalar tail rounds some pixels the
  other way (0.12 % of them in the case below, measured).
"""

import os
import sys
import xml.etree.ElementTree as ElementTree

import cv2
import h5py
import jax
import numpy as np
import pytest
import torch

from pose_transfer_tpu.core import transforms_host as jth
from pose_transfer_tpu.data import h36m_preproc as jh36m
from pose_transfer_tpu.data.dataset import PoseTransferDataset as JDataset
from pose_transfer_tpu.models import import_keras as jkeras
from pose_transfer_tpu.utils import misc as jmisc
from pose_transfer_torch.core import transforms_host as th
from pose_transfer_torch.core.skeletons import LABELS, LABELS_PAF
from pose_transfer_torch.data import h36m_preproc
from pose_transfer_torch.data.dataset import PoseTransferDataset
from pose_transfer_torch.data.synthetic import random_skeleton
from pose_transfer_torch.models import import_keras, networks
from pose_transfer_torch.models.import_flax import (
    discriminator_state_dict_from_flax, generator_state_dict_from_flax)
from pose_transfer_torch.utils import misc

from test_torch_data import SIZE, _opt, _write_both

torch.set_num_threads(2)

HEAT_ATOL = 2e-7


def _skeletons(seed, n, size, pose_dim, missing=0.15):
    """Random skeletons with missing joints, but never a hip or a shoulder
    (without them the reference's scale estimate raises KeyError)."""
    labels = LABELS if pose_dim == 16 else LABELS_PAF
    torso = [labels.index(j) for j in ("Rhip", "Lhip", "Rsho", "Lsho")]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kp = random_skeleton(rng, size, pose_dim).astype(np.float64)
        drop = rng.random(pose_dim) < missing
        drop[torso] = False
        kp[drop] = -1
        out.append(kp)
    return out


# ------------------------------------------------------------ host masks

def test_load_pose_cords_from_strings():
    y, x = "[3, -1, 17]", "[5, -1, 2]"
    got = th.load_pose_cords_from_strings(y, x)
    want = jth.load_pose_cords_from_strings(y, x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_grid_points_in_poly_and_box_masks():
    rng = np.random.default_rng(1)
    for _ in range(20):
        verts = rng.uniform(-5, 40, (rng.integers(3, 7), 2))
        verts[0, 0] = verts[1, 0]                  # a horizontal edge
        np.testing.assert_array_equal(
            th.grid_points_in_poly((32, 24), verts),
            jth.grid_points_in_poly((32, 24), verts))
        kp = rng.uniform(-3, 35, (rng.integers(1, 5), 2))
        inc = float(rng.uniform(0, 9))
        np.testing.assert_array_equal(
            th.mask_from_kp_array(kp, inc, (32, 24)),
            jth.mask_from_kp_array(kp, inc, (32, 24)))


@pytest.mark.parametrize("pose_dim", [18, 16])
def test_pose_masks(pose_dim):
    for kp in _skeletons(2, 8, (64, 48), pose_dim):
        got = th.pose_masks(kp, (64, 48), pose_dim)
        want = jth.pose_masks(kp, (64, 48), pose_dim)
        assert got.shape == (10, 64, 48) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    kp[:] = -1                      # no torso: both raise, as the reference
    for fn in (th.pose_masks, jth.pose_masks):
        with pytest.raises(KeyError):
            fn(kp, (64, 48), pose_dim)


# -------------------------------------------------------- item_reference

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("refdata")
    jdir, _ = _write_both(root, "fasion", 18)
    return jdir


@pytest.mark.parametrize("gen_type,warp_skip", [("baseline", "mask"),
                                                ("baseline", "full"),
                                                ("stacked", "mask")])
def test_item_reference_matches_jax(dataset, gen_type, warp_skip):
    opt = {**_opt(dataset, "fasion", 18), "gen_type": gen_type,
           "num_stacks": 2, "warp_skip": warp_skip}
    jd, td = JDataset(dict(opt), "test"), PoseTransferDataset(opt, "test")
    for i in range(min(len(td), 3)):
        want, got = jd.item_reference(i), td.item_reference(i)
        assert len(got) == len(want)
        for k, (a, b) in enumerate(zip(got, want)):
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, k
            heat = (gen_type == "stacked" and k == 2) or k == 0
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=HEAT_ATOL if heat else 0,
                                       err_msg=str(k))
    packed = td.item_reference(0)[0]
    assert packed.shape == (3 + 2 * 18, *SIZE)


# ------------------------------------------------------------------ keras

def _keras_kernel(w):
    """Inverse of the reference's np.transpose(w, [3, 2, 0, 1])."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _gen_layers(sd, n_enc, n_dec):
    """The generator's Keras layer list in the reference's walk order,
    with layers without weights in between, as a real Keras model has."""
    layers = [[]]
    for p in ("encoder_app", "encoder_pose"):
        layers.append([_keras_kernel(sd[f"{p}.net.0.weight"]),
                       sd[f"{p}.net.0.bias"].numpy()])
        for i in range(1, n_enc):
            layers.append([])
            layers.append([_keras_kernel(sd[f"{p}.net.{i}.net.1.weight"])])
            if i != n_enc - 1:
                layers.append([sd[f"{p}.net.{i}.net.2.weight"].numpy(),
                               sd[f"{p}.net.{i}.net.2.bias"].numpy()])
    p = "decoder"
    for i in range(n_dec - 1):
        layers += [[], [_keras_kernel(sd[f"{p}.net.{i}.net.1.weight"])], [],
                   [sd[f"{p}.net.{i}.net.3.weight"].numpy(),
                    sd[f"{p}.net.{i}.net.3.bias"].numpy()], []]
    layers.append([_keras_kernel(sd[f"{p}.net.{n_dec}.weight"]),
                   sd[f"{p}.net.{n_dec}.bias"].numpy()])
    return layers


def _disc_layers(sd, n_blocks):
    layers = [[_keras_kernel(sd["net.0.weight"]), sd["net.0.bias"].numpy()]]
    for i in range(1, n_blocks + 1):
        layers += [[], [_keras_kernel(sd[f"net.{i}.net.1.weight"])]]
        if i != n_blocks:
            layers.append([sd[f"net.{i}.net.2.weight"].numpy(),
                           sd[f"net.{i}.net.2.bias"].numpy()])
    return layers


def _write_h5(path, layers, full_model):
    """A Keras weights file: the bare ``save_weights`` layout, or a
    ``model.save`` file's ``model_weights`` group."""
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights") if full_model else f
        names = [f"layer_{i}" for i in range(len(layers))]
        g.attrs["layer_names"] = np.array([n.encode() for n in names])
        for name, ws in zip(names, layers):
            lg = g.create_group(name)
            wn = [f"{name}/w{j}:0" for j in range(len(ws))]
            lg.attrs["weight_names"] = np.array([n.encode() for n in wn])
            for n, w in zip(wn, ws):
                lg.create_dataset(n, data=w)


def _randomized(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return module


@pytest.mark.parametrize("depth", ["check", "full"])
def test_keras_generator_h5(tmp_path, depth):
    """The check-mode ladder at its widths, and the full-depth ladder (6
    stages, narrow): the walk reads back the module's own weights, and
    JAX's walk gives the same weights through the flax map."""
    if depth == "check":
        enc, dec = (64, 128), (128, 3)
    else:
        enc, dec = (8, 16, 16, 32, 32, 32), (32, 32, 32, 16, 8, 3)
    gen = _randomized(networks.DeformableGenerator(18, (64, 64), enc, dec),
                      1)
    sd = gen.state_dict()
    path = str(tmp_path / "gen.h5")
    _write_h5(path, _gen_layers(sd, len(enc), len(dec)), depth == "full")
    layers = import_keras.load_keras_h5(path)
    got = import_keras.import_generator_keras(layers, len(enc), len(dec))
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    want = generator_state_dict_from_flax(jax.tree.map(
        np.asarray, jkeras.import_generator_keras(
            jkeras.load_keras_h5(path), len(enc), len(dec))))
    assert all(torch.equal(got[k], want[k]) for k in sd)
    stacked = import_keras.import_generator_keras(layers, len(enc),
                                                  len(dec), stacked=True)
    networks.StackedGenerator(18, (64, 64), enc, dec, num_stacks=2) \
        .load_state_dict(stacked)
    with pytest.raises(ValueError, match="ran out of Keras layers"):
        import_keras.import_generator_keras(layers[:-3], len(enc), len(dec))


@pytest.mark.parametrize("check_mode", [False, True])
def test_keras_discriminator_h5(tmp_path, check_mode):
    """Full width (4 blocks) against JAX's walk; check mode with the
    port's 3 blocks (JAX's walk reads 2)."""
    disc = _randomized(networks.Discriminator(42, check_mode=check_mode), 2)
    sd = disc.state_dict()
    n_blocks = 3 if check_mode else 4
    path = str(tmp_path / "disc.h5")
    _write_h5(path, _disc_layers(sd, n_blocks), False)
    got = import_keras.import_discriminator_keras(
        import_keras.load_keras_h5(path), check_mode=check_mode)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    if not check_mode:
        want = discriminator_state_dict_from_flax(jax.tree.map(
            np.asarray, jkeras.import_discriminator_keras(
                jkeras.load_keras_h5(path))))
        assert all(torch.equal(got[k], want[k]) for k in sd)


def test_keras_walk_refuses_misordered_layers():
    gen = networks.DeformableGenerator(18, (64, 64), (64, 128), (128, 3))
    layers = [ws for ws in _gen_layers(gen.state_dict(), 2, 2) if ws]
    layers[1], layers[2] = layers[2], layers[1]
    with pytest.raises(ValueError):
        import_keras.import_generator_keras(layers, 2, 2)


# ------------------------------------------------------------------- misc

def test_mean_inputation():
    x = np.random.default_rng(3).uniform(0, 50, (6, 18, 2))
    x[x < 8] = -1
    x[:, 0, 0] = -1                               # all missing: stays nan
    np.testing.assert_array_equal(misc.mean_inputation(x),
                                  jmisc.mean_inputation(x))


def test_produce_ma_mask():
    for kp in _skeletons(4, 6, (64, 48), 18, missing=0.2):
        got = misc.produce_ma_mask(kp, (64, 48))
        assert got.dtype == bool and got.any()
        np.testing.assert_array_equal(got, jmisc.produce_ma_mask(kp,
                                                                 (64, 48)))


def test_draw_legend():
    import matplotlib.pyplot as plt

    labels = []
    for fn in (misc.draw_legend, jmisc.draw_legend):
        fig, ax = plt.subplots()
        fn(ax)
        labels.append([t.get_text() for t in ax.get_legend().get_texts()])
        plt.close(fig)
    assert labels[0] == labels[1] and len(labels[0]) > 0


# ---------------------------------------------------------- h36m_preproc

def test_square_pad_bbox_and_mask_foreground():
    rng = np.random.default_rng(5)
    for _ in range(50):
        bb = rng.uniform(-30, 1100, 4)
        bb[2:] += bb[:2]
        np.testing.assert_array_equal(
            h36m_preproc.square_pad_bbox(bb, 1000, 1002),
            jh36m.square_pad_bbox(bb, 1000, 1002))
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    bg = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    np.testing.assert_array_equal(h36m_preproc.mask_foreground(img, bg),
                                  jh36m.mask_foreground(img, bg))


def test_video_name_for():
    root = ElementTree.fromstring(
        "<r><mapping>" + "".join(
            "<row>" + "".join(f"<c>a{a}s{s}</c>" for s in range(13))
            + "</row>" for a in range(40)) + "</mapping><dbcameras><row>"
        + "".join(f"<c>{c}</c>" for c in (54138969, 55011271, 58860488,
                                           60457274)) + "</row></dbcameras>"
        "</r>")
    m, c = root.find("mapping"), root.find("dbcameras")
    for args in ((1, 2, 1, 1), (11, 16, 2, 4), (5, 7, 2, 3)):
        assert h36m_preproc.video_name_for(m, c, *args) == \
            jh36m.video_name_for(m, c, *args)


@pytest.mark.parametrize("shape", [(300, 250), (1002, 1000), (224, 224),
                                   (500, 401)])
def test_resize_equals_cv2_on_downscales(shape):
    img = np.random.default_rng(6).integers(0, 256, (*shape, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(
        h36m_preproc.resize_linear_u8(img, (224, 224)),
        cv2.resize(img, (224, 224)))


def test_resize_within_a_level_of_cv2_on_upscales():
    img = np.random.default_rng(7).integers(0, 256, (100, 130, 3),
                                            dtype=np.uint8)
    got = h36m_preproc.resize_linear_u8(img, (224, 224)).astype(int)
    diff = np.abs(got - cv2.resize(img, (224, 224)))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005


def test_process_frame_matches_jax():
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (1002, 1000, 3), dtype=np.uint8)
    bg = rng.integers(0, 256, (1002, 1000, 3), dtype=np.uint8)
    for bb in ([100, 50, 700, 900], [-20, 300, 640, 720], [400, 0, 999,
                                                             1001]):
        np.testing.assert_array_equal(
            h36m_preproc.process_frame(img, bg, np.asarray(bb)),
            jh36m.process_frame(img, bg, np.asarray(bb)))


def test_process_h36m_names_cv2_where_it_is_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        h36m_preproc.process_h36m(str(tmp_path), str(tmp_path / "x.xml"),
                                  str(tmp_path), str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")
