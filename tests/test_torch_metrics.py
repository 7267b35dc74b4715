"""The port's evaluation metrics against the JAX package's: SSIM, the
forward of ``nn_loss``, VGG19 feature extraction, and ``cli.evaluate``'s
JSON line on the same dataset and the same weights.

Tolerances (f32 on both sides; XLA and oneDNN associate the convolution
and reduction sums differently, ~1e-6 relative per layer): SSIM and the L1
and feature distances within 1e-5 absolute, feature maps within 1e-4 of
their largest magnitude. VGG weights are a random torch state_dict the
test writes itself; no weight file is fetched.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_transfer_tpu.cli import evaluate as jeval
from pose_transfer_tpu.cli.opts import Opts as JOpts
from pose_transfer_tpu.data.synthetic import write_synthetic_dataset
from pose_transfer_tpu.models import vgg as jvgg
from pose_transfer_tpu.ops.nn_loss import nn_loss as jnn_loss
from pose_transfer_tpu.ops.ssim import ssim as jssim
from pose_transfer_tpu.train import GANConfig as JConfig
from pose_transfer_tpu.train import checkpoint as jckpt
from pose_transfer_tpu.train import create_state as jcreate_state
from pose_transfer_torch.cli import evaluate as teval
from pose_transfer_torch.models import vgg as tvgg
from pose_transfer_torch.models.import_flax import (
    generator_state_dict_from_flax, vgg_state_dict_from_flax)
from pose_transfer_torch.ops.nn_loss import nn_loss
from pose_transfer_torch.ops.ssim import ssim
from pose_transfer_torch.train import checkpoint as tckpt
from pose_transfer_torch.train import engine

torch.set_num_threads(2)

ABS_TOL, FEAT_REL = 1e-5, 1e-4


def _imgs(seed, shape=(2, 40, 36, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, shape), -1, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("max_val", [2.0, 1.0])
def test_ssim_matches_jax(max_val):
    a, b = _imgs(0)
    want = float(jssim(jnp.asarray(a), jnp.asarray(b), max_val=max_val))
    got = ssim(torch.tensor(a), torch.tensor(b), max_val=max_val)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(got.item() - want) <= ABS_TOL
    assert ssim(torch.tensor(a), torch.tensor(a)).item() == pytest.approx(
        1.0, abs=1e-6)


@pytest.mark.parametrize("nh,nw", [(1, 1), (3, 3), (5, 5)])
def test_nn_loss_forward_matches_jax(nh, nw):
    a, b = _imgs(1, (2, 12, 12, 4))
    want = float(jnn_loss(jnp.asarray(a), jnp.asarray(b), nh, nw))
    got = nn_loss(torch.tensor(a), torch.tensor(b), nh, nw).item()
    assert abs(got - want) <= ABS_TOL * max(1.0, abs(want))


@pytest.fixture(scope="module")
def vgg_file(tmp_path_factory):
    """A random torchvision-layout VGG19 state_dict on disk (with a
    classifier entry, which the loaders skip)."""
    path = tmp_path_factory.mktemp("vgg") / "vgg19.pth"
    g = torch.Generator().manual_seed(0)
    sd = {}
    in_ch = 3
    for i, (kind, out_ch) in enumerate(tvgg.features_layout()):
        if kind == "conv":
            sd[f"features.{i}.weight"] = torch.randn(
                (out_ch, in_ch, 3, 3), generator=g) * (2.0 / (9 * in_ch)) ** .5
            sd[f"features.{i}.bias"] = torch.randn((out_ch,), generator=g) * .1
            in_ch = out_ch
    sd["classifier.0.weight"] = torch.zeros(2, 2)
    torch.save(sd, path)
    return str(path)


@pytest.mark.parametrize("mode", ["correct", "reference"])
@pytest.mark.parametrize("layer", ["block1_conv2", "block2_conv1",
                                   "block3_conv2"])
def test_extract_features_matches_jax(vgg_file, layer, mode):
    """Both loaders read the same file; the features agree within FEAT_REL
    of their largest magnitude."""
    assert tvgg.get_layer_ind(layer) == jvgg.get_layer_ind(layer)
    a, _ = _imgs(2, (2, 32, 24, 3))
    jp = jvgg.load_torch_vgg19_features(vgg_file)
    want = np.asarray(jvgg.extract_named(jp, jnp.asarray(a), layer, mode))
    vgg = tvgg.load_torch_vgg19_features(vgg_file, "cpu")
    got = tvgg.extract_named(vgg, torch.tensor(a), layer, mode)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FEAT_REL * np.abs(want).max())
    np.testing.assert_allclose(
        tvgg.preprocess_for_vgg(torch.tensor(a), mode).numpy(),
        np.asarray(jvgg.preprocess_for_vgg(jnp.asarray(a), mode)),
        rtol=1e-6, atol=1e-6)


def test_vgg_state_dict_from_flax_carries_jax_random_stack():
    """JAX's random VGG carried across gives JAX's features; the port's own
    seeded random VGG is another draw with the same shapes."""
    jp = jvgg.random_vgg19_features(0)
    vgg = tvgg.VGG19Features()
    vgg.load_state_dict(vgg_state_dict_from_flax(
        jax.tree.map(np.asarray, jp)))
    a, _ = _imgs(3, (1, 16, 16, 3))
    want = np.asarray(jvgg.extract_features(jp, jnp.asarray(a), 8))
    got = tvgg.extract_features(vgg, torch.tensor(a), 8).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FEAT_REL * np.abs(want).max())
    mine = tvgg.random_vgg19_features(0, device="cpu")
    assert torch.equal(mine.features[0].weight, tvgg.random_vgg19_features(
        0, device="cpu").features[0].weight)
    assert {k: v.shape for k, v in mine.state_dict().items()} == \
        {k: v.shape for k, v in vgg.state_dict().items()}


# -------------------------------------------------------------- evaluate

def _flags(root, data, exp, extra=()):
    return ["--expID", exp, "--data_Dir", data, "--dataset", "market",
            "--pose_dim", "18", "--batch_size", "2", "--checkMode", "1",
            "--exp_root", str(root / "exp"), "--num_devices", "1",
            *extra]


@pytest.mark.parametrize("feat", [("--feat_layer", "block1_conv2"),
                                  ("--feat_layer", "none")])
def test_evaluate_json_matches_jax(tmp_path, vgg_file, feat):
    """One check-mode generator (JAX's init, carried to the port), the
    JAX writer's dataset (JPEG, read through PIL on both sides) and the
    same VGG file: the port's JSON line has JAX's keys and values."""
    data = str(tmp_path / "data") + "/"
    write_synthetic_dataset(data, dataset="market", pose_dim=18,
                            num_people=3, images_per_person=3,
                            img_size=(128, 64))
    extra = ("--vgg_weights", vgg_file, "--max_batches", "3", *feat)
    p = JOpts()
    p.init()
    p.parser.add_argument("--max_batches", default=0, type=int)
    p.parser.add_argument("--feat_layer", default="block1_conv2")
    jopt = JOpts.derive(p.parser.parse_args(_flags(tmp_path, data, "j",
                                                   extra)))
    jcfg = JConfig.from_opt(jopt)
    jstate, _, _ = jcreate_state(jcfg, seed=0)
    jckpt.save(jstate, jopt.checkpoints_dir, 3)
    want = jeval.evaluate(jopt, 3)

    state = engine.create_state(engine.GANConfig.from_opt(jopt),
                                device="cpu")
    state.gen.load_state_dict(generator_state_dict_from_flax(
        jax.tree.map(np.asarray, jstate.gen_params)))
    tckpt.save(state, str(tmp_path / "exp" / "t" / "models"), 3)
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        teval.main(_flags(tmp_path, data, "t",
                          (*extra, "--resume", "1", "--device", "cpu")))
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(got) == list(want)
    assert got["epoch"] == want["epoch"] == 3
    assert got["num_batches"] == want["num_batches"] == 3
    for k in ("value", "l1", "feat_l2", "feat_l1"):
        if k in want:
            assert abs(got[k] - want[k]) <= ABS_TOL + 1e-6, k
    # PSNR is printed to 3 decimals; feat_nn sums 64 channels
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3 + 1e-6
    if "feat_nn" in want:
        assert got["feat_nn"] == pytest.approx(want["feat_nn"], rel=FEAT_REL)
        assert got["feat_layer"] == want["feat_layer"]
