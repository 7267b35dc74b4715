"""The port's stacked and U-Net generators against the JAX package's: the
pose interpolation and the stacked fit chain, the synthetic batches, the
dataset's samples and the batch preparers of both types, both generators'
forwards and one two-phase step each, ``gaussian_weights_init``, the
servers, the stacked grid, and the CLI flow a user runs: a content-loss
``full_fasion128128`` run, a stacked run that warm-starts from it, then
``test`` and ``evaluate`` (and a U-Net run with the gaussian init).

Models at 64², pose_dim 18, batch 2, f32, narrow ladders, dropout off, the
same weights on both sides (``models.import_flax``); the folds take the
full scan (``warp_windowed`` off) on both sides. Host arrays are compared
bit for bit; tensors as tests/test_torch_train.py holds them. The steps'
JAX side takes its volume-norm variance about the mean
(``_jnorm_two_pass``): with the package's one-pass E[x²] − E[x]² in f32 on
XLA:CPU, the U-Net's encoder gradients move by up to 13 % of a tensor's
largest entry against an f64 run of the same math, where the port's f32
ones stay within 3e-4 (``test_unet_gradient_gap_is_jax_cpu_norm_stats``).
"""

import contextlib
import dataclasses
import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_transfer_tpu.core import pose as jpose
from pose_transfer_tpu.data import annotations as jann
from pose_transfer_tpu.data import dataset as jdataset
from pose_transfer_tpu.data import synthetic as jsyn
from pose_transfer_tpu.data.device import make_batch_preparer as jprep
from pose_transfer_tpu.models import Discriminator as JDisc
from pose_transfer_tpu.models import networks as jnet
from pose_transfer_tpu.models.import_torch import (import_discriminator,
                                                   import_generator)
from pose_transfer_tpu.serve import PoseTransferServer as JServer
from pose_transfer_tpu.train import GANConfig as JConfig
from pose_transfer_tpu.train import engine as jengine
from pose_transfer_tpu.train import losses as jlosses
from pose_transfer_tpu.utils import visualize as jvis
from pose_transfer_torch.cli import evaluate, main, make_synthetic_data
from pose_transfer_torch.cli import test as infer
from pose_transfer_torch.core import pose as tpose
from pose_transfer_torch.data import annotations as tann
from pose_transfer_torch.data import dataset as tdataset
from pose_transfer_torch.data import synthetic as tsyn
from pose_transfer_torch.data.device import make_batch_preparer as tprep
from pose_transfer_torch.models import networks
from pose_transfer_torch.models.import_flax import (
    discriminator_state_dict_from_flax, generator_state_dict_from_flax)
from pose_transfer_torch.serve import PoseTransferServer
from pose_transfer_torch.tools import profile_train
from pose_transfer_torch.tools.profile_serve import config_for
from pose_transfer_torch.train import checkpoint, engine
from pose_transfer_torch.utils import image_io
from pose_transfer_torch.utils import visualize as tvis

from _source_fits import fits_from_source  # noqa: F401  (fixture)

torch.set_num_threads(2)

SIZE = (64, 64)
N = 2
ENC = (8, 16, 16, 16)
DEC = (16, 16, 16, 3)
IN_NC = 3 + 2 * 18
# heatmaps: XLA's and torch's exp may differ by an ulp (tests/test_torch_ops)
ULP_RTOL, ULP_ATOL = 2e-7, 1.2e-7
# models, as tests/test_torch_train.py holds them: convolution and
# reduction sums associate differently in XLA and oneDNN (~1e-6 relative
# per layer); gradients through a whole backward within 1e-4 of each
# tensor's largest entry
F32_ATOL, LOSS_RTOL, GRAD_RTOL, GRAD_SCALE = 1e-4, 1e-5, 1e-4, 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnorm_two_pass(x, weight, bias, eps=1e-3):
    """JAX's volume instance norm with the variance taken about the mean
    (two passes), in x's dtype (f32 in the steps), where
    ``pose_transfer_tpu/ops/norm.py`` takes E[x²] − E[x]² in one, in f32."""
    mean = jnp.mean(x, axis=(1, 2, 3), keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=(1, 2, 3), keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * weight + bias


def _norm_f64(x, weight, bias, eps=1e-3):
    """The port's volume instance norm in x's dtype, for a true f64 run."""
    dims = tuple(range(1, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def _perturb_scalars(params):
    """Nonzero norm affines, so that the mapping of every leaf matters."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * (len(jax.tree_util.keystr(path)) % 5)
        if x.ndim == 0 else x, params)


# ---------------------------------------------------------- host data path

# limb joints (the fits need the torso's): missing in the source, missing
# in the target, missing on both sides
MISSING = {18: (4, 7, 16), 16: (11, 14, 10)}


def _pose_pair(rng, pose_dim):
    kp = [tsyn.random_skeleton(rng, SIZE, pose_dim) for _ in range(2)]
    src, tgt, both = MISSING[pose_dim]
    kp[0][src] = kp[1][tgt] = kp[0][both] = kp[1][both] = -1
    return [k.astype(np.float32) for k in kp]


@pytest.mark.parametrize("num_stacks", [3, 4])
@pytest.mark.parametrize("pose_dim", [16, 18])
def test_pose_interpolation_matches_jax(pose_dim, num_stacks):
    """``compute_interpol_pose`` and ``interpol_pose_sequence`` bit for bit
    against JAX's, and near the host twin the data path uses; pose_dim
    18's missing joints stay missing up to the halfway stack and snap to
    their side after it."""
    kp_from, kp_to = _pose_pair(np.random.default_rng(pose_dim), pose_dim)
    for i in range(1, num_stacks + 1):
        got = tpose.compute_interpol_pose(torch.tensor(kp_from),
                                          torch.tensor(kp_to), i,
                                          num_stacks, pose_dim).numpy()
        want = np.asarray(jpose.compute_interpol_pose(
            kp_from, kp_to, i, num_stacks, pose_dim))
        np.testing.assert_array_equal(got, want)
        # the host twins compute in float64: bit for bit with each other,
        # and within the device function's three f32 roundings (a
        # difference, a product, a sum) of it
        host = tann.interpolate_keypoints_host(kp_from, kp_to, i,
                                               num_stacks, pose_dim)
        np.testing.assert_array_equal(host, jann.interpolate_keypoints_host(
            kp_from, kp_to, i, num_stacks, pose_dim))
        np.testing.assert_allclose(got, host, rtol=3 * 2 ** -24, atol=0)
        if pose_dim == 18:
            src, tgt, both = MISSING[pose_dim]
            first_half = i <= num_stacks // 2
            assert (got[src] == -1).all() == first_half
            assert (got[tgt] == -1).all() != first_half
            assert (got[both] == -1).all()
    seq = tpose.interpol_pose_sequence(torch.tensor(kp_from),
                                       torch.tensor(kp_to), num_stacks,
                                       pose_dim).numpy()
    np.testing.assert_array_equal(seq, np.asarray(jpose.interpol_pose_sequence(
        kp_from, kp_to, num_stacks, pose_dim)))
    if pose_dim == 16:
        np.testing.assert_array_equal(seq[-1], kp_to)


@pytest.mark.usefixtures("fits_from_source")
@pytest.mark.parametrize("warp_skip", ["mask", "full"])
@pytest.mark.parametrize("pose_dim", [16, 18])
def test_interpol_chain_matches_jax(pose_dim, warp_skip):
    rng = np.random.default_rng(1)
    for _ in range(3):
        kp_from, kp_to = _pose_pair(rng, pose_dim)
        got = tdataset.interpol_chain(kp_from, kp_to, pose_dim, SIZE,
                                      warp_skip, 4)
        want = jdataset.interpol_chain(kp_from, kp_to, pose_dim, SIZE,
                                       warp_skip, 4)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert got[1].shape[0] == 5          # num_stacks + 1 fits


@pytest.mark.usefixtures("fits_from_source")
@pytest.mark.parametrize("gen_type,warp_skip", [
    ("stacked", "mask"), ("stacked", "full"), ("unet", "mask")])
def test_synthetic_batch_matches_jax(gen_type, warp_skip):
    """The same draws from the same seed, key for key."""
    kw = dict(warp_skip=warp_skip, gen_type=gen_type, num_stacks=3)
    got = tsyn.synthetic_compact_batch(np.random.default_rng(2), 2, SIZE, 18,
                                       **kw)
    want = jsyn.synthetic_compact_batch(np.random.default_rng(2), 2, SIZE,
                                        18, **kw)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacked_data")) + "/"
    jsyn.write_synthetic_dataset(root, dataset="fasion", pose_dim=18,
                                 num_people=2, images_per_person=3,
                                 img_size=SIZE, seed=4)
    opt = {"num_stacks": 3, "pose_dim": 18, "image_size": SIZE,
           "use_input_pose": 1, "warp_skip": "mask", "dataset": "fasion"}
    for s in ("train", "test"):
        opt[f"images_dir_{s}"] = f"{root}fasion-dataset/{s}"
        opt[f"annotations_file_{s}"] = f"{root}fasion-annotation-{s}.csv"
        for x in ("", "_interpol", "_check"):
            opt[f"pairs_file_{s}{x}"] = \
                f"{root}fasion-pairs-{s}{x.replace('_', '-')}.csv"
    return opt


@pytest.mark.usefixtures("fits_from_source")
@pytest.mark.parametrize("gen_type", ["stacked", "unet"])
def test_dataset_samples_match_jax(jax_dataset, gen_type):
    """On the JAX writer's dataset: every sample key for key, exactly (the
    U-Net's carries no fits); the fit cache returns what it stored."""
    opt = {**jax_dataset, "gen_type": gen_type}
    jd = jdataset.PoseTransferDataset(dict(opt), "train")
    td = tdataset.PoseTransferDataset(dict(opt), "train")
    assert len(td) == len(jd) > 0
    for i in range(len(td)):
        want, got = jd.item_compact(i), td.item_compact(i)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    again = td.item_compact(0)
    assert ("interpol_warps" in again) == (gen_type == "stacked")
    assert "warps" not in again and "mask_polys" not in again


@pytest.mark.parametrize("gen_type,warp_skip", [
    ("stacked", "mask"), ("stacked", "full"), ("unet", "mask")])
def test_batch_preparers_match_jax(gen_type, warp_skip):
    """The stacked preparer's stage heatmaps (stage-major channels), fits
    and (S+1)·T masks; the U-Net's packed input alone."""
    b = jsyn.synthetic_compact_batch(np.random.default_rng(5), 3, SIZE, 18,
                                     warp_skip=warp_skip, gen_type=gen_type,
                                     num_stacks=3)
    kw = dict(image_size=SIZE, pose_dim=18, warp_skip=warp_skip,
              gen_type=gen_type, num_stacks=3)
    got = tprep(device="cpu", **kw)(b)
    want = jprep(**kw)(b)
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
            continue
        assert tuple(got[k].shape) == v.shape, k
        if k in ("interpol_warps", "interpol_masks"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=ULP_RTOL, atol=ULP_ATOL,
                                       err_msg=k)
    if gen_type == "stacked":
        assert got["interpol_pose"].shape == (3, *SIZE, 3 * 18)
        if warp_skip == "mask":
            assert got["interpol_masks"].shape == (3, 4, 10, *SIZE)


# ------------------------------------------------------------------ models

def _jax_gen(gen_type, num_stacks=2):
    if gen_type == "stacked":
        return jnet.StackedGenerator(pose_dim=18, image_size=SIZE,
                                     nfilters_enc=ENC, nfilters_dec=DEC,
                                     num_stacks=num_stacks)
    return jnet.UNetGenerator(nfilters_enc=ENC, nfilters_dec=DEC)


def _port_gen(gen_type, params, num_stacks=2):
    if gen_type == "stacked":
        gen = networks.StackedGenerator(18, SIZE, ENC, DEC,
                                        num_stacks=num_stacks)
    else:
        gen = networks.UNetGenerator(IN_NC, ENC, DEC)
    gen.load_state_dict(generator_state_dict_from_flax(params))
    return gen


def _gen_args(gen_type, prepared):
    if gen_type == "stacked":
        return (prepared["input"], prepared["interpol_pose"],
                prepared["interpol_warps"], prepared["interpol_masks"])
    return (prepared["input"],)


def _configs(gen_type, num_stacks=2, **kw):
    kw = dict(image_size=SIZE, pose_dim=18, batch_size=N, gen_type=gen_type,
              num_stacks=num_stacks, warp_windowed=False, **kw)
    return JConfig(**kw), engine.GANConfig(**kw)


def _batch(seed, gen_type, num_stacks=2, n=N):
    return jsyn.synthetic_compact_batch(np.random.default_rng(seed), n, SIZE,
                                        18, gen_type=gen_type,
                                        num_stacks=num_stacks)


def _jax_params(gen_type, num_stacks=2, seed=0):
    jcfg, _ = _configs(gen_type, num_stacks)
    p0 = jprep(image_size=SIZE, pose_dim=18, gen_type=gen_type,
               num_stacks=num_stacks)(_batch(9, gen_type, num_stacks, 1))
    jgen = _jax_gen(gen_type, num_stacks)
    params = _np(_perturb_scalars(jax.jit(functools.partial(
        jgen.init, train=False))({"params": jax.random.PRNGKey(seed)},
                                 *_gen_args(gen_type, p0))))
    return jgen, params


@pytest.mark.parametrize("gen_type,num_stacks", [
    ("stacked", 2), ("stacked", 4), ("unet", 0)])
def test_forward_matches_jax(gen_type, num_stacks):
    """``make_eval_step`` of each package on the same batch and weights:
    every stage of the stacked generator, (S, N, H, W, 3)."""
    jcfg, cfg = _configs(gen_type, num_stacks)
    jgen, params = _jax_params(gen_type, num_stacks)
    batch = _batch(10, gen_type, num_stacks)
    want, _ = jengine.make_eval_step(jcfg, jgen)(params, batch)
    got, prepared = engine.make_eval_step(
        cfg, _port_gen(gen_type, params, num_stacks), device="cpu")(batch)
    shape = (num_stacks, N, *SIZE, 3) if gen_type == "stacked" \
        else (N, *SIZE, 3)
    assert tuple(got.shape) == want.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL,
                               rtol=0)


def test_stacked_state_dict_reads_back_through_jax_importer():
    """The port's stacked names are the reference's: ``generator.``-prefixed
    keys that JAX's ``import_generator(stacked=True)`` maps back to the same
    params; the U-Net's are ``encoder.*`` and ``decoder.*``."""
    _, params = _jax_params("stacked")
    sd = _port_gen("stacked", params).state_dict()
    assert all(k.startswith("generator.") for k in sd)
    back = _np(import_generator({k: v.numpy() for k, v in sd.items()},
                                len(ENC), len(DEC), stacked=True))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    _, uparams = _jax_params("unet")
    usd = _port_gen("unet", uparams).state_dict()
    assert {k.split(".")[0] for k in usd} == {"encoder", "decoder"}


@pytest.fixture(scope="module", params=["stacked", "unet"])
def step_case(request):
    """Both sides of one dropout-off step from the same weights: the
    stacked generator of 2 stages, or the U-Net."""
    gen_type = request.param
    jcfg, cfg = _configs(gen_type)
    jgen, gen_params = _jax_params(gen_type)
    jdisc = JDisc()
    disc_params = _np(_perturb_scalars(jdisc.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, *SIZE, IN_NC + 3)),
        train=False)))
    fake, real, gen_b = (_batch(s, gen_type) for s in (11, 12, 13))
    prep = jprep(image_size=SIZE, pose_dim=18, gen_type=gen_type,
                 num_stacks=2)

    gen = _port_gen(gen_type, gen_params)
    disc = networks.Discriminator(IN_NC + 3)
    disc.load_state_dict(discriminator_state_dict_from_flax(disc_params))
    state = engine.TrainState(
        gen=gen, disc=disc,
        gen_opt=engine.make_optimizer(cfg, gen.parameters()),
        disc_opt=engine.make_optimizer(cfg, disc.parameters()),
        rng=torch.Generator().manual_seed(0))
    stack = lambda b: {k: v[None] for k, v in b.items()}   # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(networks.ChannelDropout, "forward", lambda self, x: x)
        metrics, out_gen = engine.make_train_step(cfg, state)(
            stack(fake), stack(real), gen_b)
    port = {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "out_gen": out_gen.numpy(),
            "gen_grads": {k: p.grad.clone()
                          for k, p in gen.named_parameters()},
            "disc_grads": {k: p.grad.clone()
                           for k, p in disc.named_parameters()}}

    def disc_loss(dp, gp, fk, rl):
        out = jax.lax.stop_gradient(
            jengine.gen_apply(jgen, gp, fk, jcfg, train=False)[0])
        both = jnp.concatenate(
            [jengine.disc_input(rl["input"], rl["target"], jcfg),
             jengine.disc_input(fk["input"], out, jcfg)], axis=0)
        res = jdisc.apply(dp, both, train=True)
        t, f = jlosses.disc_adversarial_loss(res[:N], res[N:], 1.0, N)
        return t + f, (t, f)

    def gen_loss(gp, dp, b):
        out, stages = jengine.gen_apply(jgen, gp, b, jcfg, train=False)
        d_out = jdisc.apply(dp, jengine.disc_input(b["input"], out, jcfg),
                            train=True)
        ad = jlosses.gen_adversarial_loss(d_out, 1.0, N)
        ll = jlosses.l1_loss(out, b["target"]) * 100.0
        return ad + ll, (ll, ad, jnp.stack(stages) if stages else out)

    # the generator phase against the port's updated discriminator (as in
    # tests/test_torch_train.py: Adam's first update is ≈ lr·sign(g))
    disc_new = _np(import_discriminator(
        {k: v.detach().numpy() for k, v in disc.state_dict().items()}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnet, "volume_instance_norm", _jnorm_two_pass)
        (d_total, (d_true, d_fake)), d_grads = jax.jit(jax.value_and_grad(
            disc_loss, has_aux=True))(disc_params, gen_params, prep(fake),
                                      prep(real))
        (g_total, (ll, ad, out)), g_grads = jax.jit(jax.value_and_grad(
            gen_loss, has_aux=True))(gen_params, disc_new, prep(gen_b))
    ref = {"metrics": {"gen": np.array([g_total, ll, ad], np.float32),
                       "disc": np.array([d_total, d_true, d_fake],
                                        np.float32)},
           "out_gen": np.asarray(out),
           "gen_grads": generator_state_dict_from_flax(_np(g_grads)),
           "disc_grads": discriminator_state_dict_from_flax(_np(d_grads))}
    return gen_type, port, ref


def test_step_losses_and_outputs_match_jax(step_case):
    """[total, ll, ad], [total, true, fake]; the stacked step surfaces
    every stage's image, (S, N, H, W, 3), and the discriminator saw the
    last."""
    gen_type, port, ref = step_case
    for phase in ("gen", "disc"):
        np.testing.assert_allclose(port["metrics"][phase],
                                   ref["metrics"][phase], rtol=LOSS_RTOL,
                                   err_msg=phase)
    shape = (2, N, *SIZE, 3) if gen_type == "stacked" else (N, *SIZE, 3)
    assert port["out_gen"].shape == ref["out_gen"].shape == shape
    np.testing.assert_allclose(port["out_gen"], ref["out_gen"],
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("net", ["gen", "disc"])
def test_step_gradients_match_jax(step_case, net):
    _, port, ref = step_case
    got, want = port[f"{net}_grads"], ref[f"{net}_grads"]
    assert set(got) == set(want)
    for k in want:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_SCALE * np.abs(w).max(),
                                   err_msg=f"{net}: {k}")
        assert np.abs(w).max() > 0, f"{net}: {k} has no gradient"


def test_unet_gradient_gap_is_jax_cpu_norm_stats():
    """Why the steps' JAX side takes its norm variance in two passes: the
    U-Net's generator gradients (a fixed cotangent on its output) against
    the port's f64 run (its norm in f64 too) — the JAX package's f32 run
    with its own one-pass norm stats beyond 1e-2 of some tensor's largest
    entry (measured 0.126, a norm scale of the first encoder block); the
    port's f32 run within 1e-3 (measured 2.6e-4) and JAX's with the
    two-pass variance within 1e-3 (4.0e-4); JAX's f64 run (two-pass, f64
    model) within 1e-6 (3e-7): the same math."""
    jgen, params = _jax_params("unet")
    prepared = jprep(image_size=SIZE, pose_dim=18, gen_type="unet")(
        _batch(13, "unet"))
    ct = np.random.default_rng(0).standard_normal((N, *SIZE, 3)) \
        .astype(np.float32)

    def jax_grads():
        g = jax.jit(jax.grad(lambda p: jnp.sum(jgen.apply(
            p, prepared["input"], train=False) * ct)))(params)
        return {k: v.double().numpy() for k, v in
                generator_state_dict_from_flax(_np(g)).items()}

    def port_grads(dtype):
        gen = _port_gen("unet", params).to(dtype).eval()
        gen.dtype = dtype
        out = gen(torch.tensor(np.asarray(prepared["input"])).to(dtype))
        (out * torch.tensor(ct).to(dtype)).sum().backward()
        return {k: p.grad.double().numpy() for k, p in gen.named_parameters()}

    def rel(got, want):
        return max(float(np.abs(got[k] - want[k]).max()
                         / np.abs(want[k]).max()) for k in want)

    f32, plain = port_grads(torch.float32), jax_grads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(networks, "volume_instance_norm", _norm_f64)
        f64 = port_grads(torch.float64)
        mp.setattr(jnet, "volume_instance_norm", _jnorm_two_pass)
        two_pass = jax_grads()
        jgen = jnet.UNetGenerator(nfilters_enc=ENC, nfilters_dec=DEC,
                                  dtype=jnp.float64)
        with jax.enable_x64(True):
            params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                  params)
            prepared = {"input": np.asarray(prepared["input"], np.float64)}
            ct = ct.astype(np.float64)
            jax64 = jax_grads()
    assert rel(plain, f64) > 1e-2
    assert rel(f32, f64) <= 1e-3
    assert rel(two_pass, f64) <= 1e-3
    assert rel(jax64, f64) <= 1e-6


def _conv_weights(module):
    return [m.weight for m in module.modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]


@pytest.mark.parametrize("gen_type", ["baseline", "stacked", "unet"])
def test_gaussian_weights_init_distribution(gen_type):
    """``weight_init='gaussian'``: every conv and transposed-conv weight of
    both nets drawn from N(0, 0.02) (each tensor's std within 10 %, all of
    them pooled within 1 %, as JAX's pooled kernels are), biases zero and
    the norms' affines one and zero as under the Glorot init; the draw is
    the seed's."""
    cfg = engine.GANConfig(image_size=SIZE, check_mode=True,
                           gen_type=gen_type, num_stacks=2,
                           weight_init="gaussian")
    st = engine.create_state(cfg, seed=3, device="cpu")
    pooled = []
    for net in (st.gen, st.disc):
        for w in _conv_weights(net):
            assert abs(w.std().item() - 0.02) < 0.1 * 0.02
            pooled.append(w.detach().flatten())
        for name, p in net.named_parameters():
            if name.endswith("bias") or p.numel() == 1:
                want = 1.0 if name.endswith("weight") else 0.0
                assert (p == want).all(), name
    pooled = torch.cat(pooled)
    assert abs(pooled.std().item() - 0.02) < 0.01 * 0.02
    assert abs(pooled.mean().item()) < 0.01 * 0.02
    # JAX's redraw on its parameter shapes (zeros stand in for its init)
    jcfg = JConfig(image_size=SIZE, check_mode=True, gen_type=gen_type,
                   num_stacks=2)
    jgen, jdisc = jengine.build_models(jcfg)
    inp, gen_args = jengine._example_batch(jcfg)
    shapes = jax.eval_shape(lambda: (
        jgen.init({"params": jax.random.PRNGKey(0)}, inp, *gen_args,
                  train=False),
        jdisc.init({"params": jax.random.PRNGKey(0)},
                   jnp.zeros((1, *SIZE, IN_NC + 3)), train=False)))
    drawn = jnet.gaussian_weights_init(
        jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shapes),
        jax.random.PRNGKey(3))
    kernels = np.concatenate([np.asarray(x).ravel()
                              for x in jax.tree.leaves(drawn)
                              if np.ndim(x) == 4])
    assert abs(kernels.std() - 0.02) < 0.01 * 0.02
    assert kernels.size == pooled.numel()
    again = engine.create_state(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(_conv_weights(again.gen), _conv_weights(st.gen)))


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(jsyn.random_image(rng, SIZE),
             jsyn.random_skeleton(rng, SIZE, 18).astype(np.float32),
             jsyn.random_skeleton(rng, SIZE, 18).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("gen_type", ["stacked", "unet"])
def test_server_matches_jax_server(gen_type):
    """Same weights, same requests (an odd count: one padded batch); the
    stacked server answers with the last stage."""
    jcfg, cfg = _configs(gen_type)
    jgen, params = _jax_params(gen_type)
    reqs = _requests(3, seed=14)
    with JServer(jcfg, jgen, params, max_wait_ms=20.0) as srv:
        want = srv.generate(reqs)
    gen = _port_gen(gen_type, params)
    with PoseTransferServer(cfg, gen, max_wait_ms=20.0, device="cpu") as srv:
        sample = srv.prepare_request(*reqs[0])
        got = srv.generate(reqs)
    assert got.shape == want.shape == (3, *SIZE, 3)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    keys = {"stacked": {"interpol_kp", "interpol_warps", "interpol_polys",
                        "interpol_kinds"}, "unet": set()}[gen_type]
    assert set(sample) == {"image_from", "kp_from", "kp_to"} | keys


def test_display_stacked_matches_jax():
    """The stacked grid, pixel for pixel: input, the stages' skeletons,
    target, every stage's output."""
    b = jprep(image_size=SIZE, pose_dim=18, gen_type="stacked",
              num_stacks=3)(_batch(15, "stacked", 3))
    outs = np.random.default_rng(0).uniform(-1, 1, (3, N, *SIZE, 3)) \
        .astype(np.float32)
    args = [np.asarray(b["input"]), np.asarray(b["interpol_pose"]),
            np.asarray(b["target"])]
    want = jvis.display_stacked(*args, list(outs), 3, True, 18)
    got = tvis.display_stacked(*[torch.tensor(a) for a in args],
                               torch.tensor(outs), 3, True, 18)
    assert got.shape == (N * SIZE[0], 8 * SIZE[1], 3) == want.shape
    np.testing.assert_array_equal(got, want)


def test_profilers_configure_the_new_paths():
    """The profilers' --gen_type and --content_loss_layer: full-width bf16
    configs, the content loss as the full_fasion recipe, and batches of the
    generator type."""
    cfg = config_for("fasion", 8, "matmul", "stacked", "block1_conv2")
    assert (cfg.gen_type, cfg.num_stacks, cfg.content_loss_layer,
            cfg.nn_loss_area_size, cfg.l1_penalty_weight) == \
        ("stacked", 4, "block1_conv2", 5, 1.0)
    assert config_for("fasion", 8, "matmul").content_loss_layer == "none"
    small = dataclasses.replace(cfg, image_size=SIZE, batch_size=2,
                                num_stacks=2)
    fake, _, gen_b = profile_train._batches(small, np.random.default_rng(0),
                                            1)[0]
    assert fake["interpol_warps"].shape == (1, 2, 3, 10, 8)
    assert gen_b["interpol_kp"].shape == (2, 2, 18, 2)


# --------------------------------------------------------------------- CLI

def _run(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def fasion_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_stacked")
    data = str(root / "data") + "/"
    _run(make_synthetic_data.main, ["--out", data, "--dataset",
                                    "fasion128128", "--pose_dim", "18",
                                    "--num_people", "2"])
    return root, data


def _flags(root, data, exp, **over):
    base = {"--expID": exp, "--data_Dir": data, "--dataset": "fasion128128",
            "--pose_dim": "18", "--batch_size": "2", "--iters_per_epoch": "2",
            "--number_of_epochs": "1", "--display_ratio": "1",
            "--checkpoint_ratio": "1", "--checkMode": "1",
            "--exp_root": str(root / "exp"), "--device": "cpu"}
    base.update({k: str(v) for k, v in over.items()})
    return [x for kv in base.items() for x in kv]


def test_cli_full_fasion_then_stacked(fasion_data, monkeypatch):
    """The reference's full_fasion recipe (content loss block1_conv2, area
    5, L1 weight 1.0), then a stacked run that warm-starts its shared
    generator from that run's checkpoint, then the stacked test grids
    (every stage) and evaluate's finite metrics on the last stage."""
    root, data = fasion_data
    out = _run(main.main, _flags(
        root, data, "full_fasion128128", **{
            "--content_loss_layer": "block1_conv2",
            "--nn_loss_area_size": 5, "--l1_penalty_weight": 1.0}))
    assert out.count("img/s") == 2
    full = root / "exp" / "full_fasion128128"
    rows = [json.loads(ln) for ln in open(full / "metrics.jsonl")]
    assert all(np.isfinite(r["gen_ll"]) and r["gen_ll"] > 0 for r in rows)
    warm = full / "models" / "gen_001.pt"
    assert warm.exists()

    loads = []
    orig = checkpoint.load_params
    monkeypatch.setattr(checkpoint, "load_params",
                        lambda p, m: loads.append((p, m)) or orig(p, m))
    flags = _flags(root, data, "stacked", **{"--gen_type": "stacked",
                                             "--num_stacks": 2})
    out = _run(main.main, flags)
    assert f"Warm-started stacked generator from {warm}" in out
    (path, module), = loads
    assert path == str(warm) and isinstance(module,
                                            networks.DeformableGenerator)
    exp = root / "exp" / "stacked"
    grid = image_io.read_image(str(exp / "results" / "test" /
                                   "epoch_001_00000.png"))
    # input | 2 stage skeletons | target | 2 stage outputs, 2 rows
    assert grid.shape == (2 * 128, 6 * 128, 3)

    out = _run(infer.main, flags + ["--resume", "1"])
    assert "epoch-1 weights" in out
    grids = sorted(os.listdir(exp / "results" / "generated"))
    assert grids and grids[0] == "images_batch_00000.png"
    assert image_io.read_image(str(exp / "results" / "generated" /
                                   grids[0])).shape == (256, 768, 3)
    res = json.loads(_run(evaluate.main, flags + [
        "--resume", "1", "--max_batches", "2"]).strip().splitlines()[-1])
    assert res["epoch"] == 1 and res["num_batches"] == 2
    assert all(np.isfinite(res[k]) for k in ("value", "l1", "psnr",
                                             "feat_l2", "feat_nn"))


def test_cli_stacked_without_a_deformable_run(fasion_data):
    """No ``full_<dataset>`` checkpoint: the stacked run says so and trains
    from scratch."""
    root, data = fasion_data
    out = _run(main.main, _flags(root, data, "s2", **{
        "--gen_type": "stacked", "--num_stacks": 2, "--exp_root":
            str(root / "exp_empty"), "--iters_per_epoch": 1}))
    assert "training stacked generator from scratch" in out
    assert "Warm-started" not in out


def test_cli_unet_gaussian_train_test_evaluate(fasion_data):
    root, data = fasion_data
    flags = _flags(root, data, "unet", **{"--gen_type": "unet",
                                          "--weight_init": "gaussian",
                                          "--warp_skip": "none"})
    out = _run(main.main, flags)
    assert out.count("img/s") == 2
    state = torch.load(root / "exp" / "unet" / "models" / "gen_001.pt",
                       weights_only=True)
    assert "encoder.net.0.weight" in state
    out = _run(infer.main, flags + ["--resume", "1"])
    assert "epoch-1 weights" in out
    res = json.loads(_run(evaluate.main, flags + [
        "--resume", "1", "--max_batches", "1"]).strip().splitlines()[-1])
    assert np.isfinite(res["value"]) and res["num_batches"] == 1
