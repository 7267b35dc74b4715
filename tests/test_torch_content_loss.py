"""The port's content-loss training (the reference's full_fasion recipe)
against the JAX package's: ``nn_loss`` with its argmin-routed backward, the
VGG19 features in the compute dtype's promotion, the frozen VGG of the
training state and one two-phase step with ``content_loss_layer=
'block1_conv2'``, area 5, L1 weight 1.0.

The step runs at 64², pose_dim 18, batch 2, f32, dropout off on both sides,
from the same generator, discriminator and VGG weights (carried across by
``models.import_flax``; the VGG is the JAX package's seeded random stack).
Both folds take the full scan (``warp_windowed`` off): the kernels are held
elsewhere, and the scan keeps the JAX side out of Pallas' interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_transfer_tpu.data import synthetic as jsyn
from pose_transfer_tpu.data.device import make_batch_preparer as jprep
from pose_transfer_tpu.models import DeformableGenerator as JGen
from pose_transfer_tpu.models import Discriminator as JDisc
from pose_transfer_tpu.models import vgg as jvgg
from pose_transfer_tpu.models.import_torch import import_discriminator
from pose_transfer_tpu.ops.nn_loss import nn_loss as jnn_loss
from pose_transfer_tpu.train import GANConfig as JConfig
from pose_transfer_tpu.train import engine as jengine
from pose_transfer_tpu.train import losses as jlosses
from pose_transfer_torch.models import networks
from pose_transfer_torch.models import vgg as tvgg
from pose_transfer_torch.models.import_flax import (
    discriminator_state_dict_from_flax, generator_state_dict_from_flax,
    vgg_state_dict_from_flax)
from pose_transfer_torch.ops import nn_loss as tnn
from pose_transfer_torch.train import checkpoint, engine

torch.set_num_threads(2)

SIZE = (64, 64)
N = 2
ENC = (16, 16, 32, 32, 32)
DEC = (32, 32, 16, 16, 3)
IN_CH = 3 + 2 * 18 + 3
RECIPE = dict(content_loss_layer="block1_conv2", nn_loss_area_size=5,
              l1_penalty_weight=1.0)
# nn_loss: the same shifts and the same sums, so the values agree to an f32
# rounding (bf16: one ulp, 2^-8 of the value); the cotangents are exact
# where both packages pick the same shift. A pixel where their channel sums
# rank two shifts the other way routes its cotangent elsewhere: up to
# FLIP_SHARE of the pixels may differ (measured: none, at C = 64, in both
# dtypes).
NN_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}
FLIP_SHARE = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
# the step, as tests/test_torch_train.py holds it (convolution and reduction
# sums associate differently in XLA and oneDNN; ~1e-5 of each gradient
# tensor's largest entry through a whole backward)
LOSS_RTOL, GRAD_RTOL, GRAD_SCALE = 1e-5, 1e-4, 1e-4


def _features(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    p, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return p, g


def _jax_nn(p, g, area, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    val, grads = jax.value_and_grad(
        lambda x, y: jnn_loss(x, y, area, area).astype(jnp.float32),
        argnums=(0, 1))(jnp.asarray(p, jdt), jnp.asarray(g, jdt))
    return float(val), [np.asarray(d.astype(jnp.float32)) for d in grads]


def _port_nn(p, g, area, dtype):
    tp = torch.tensor(p).to(dtype).requires_grad_(True)
    tg = torch.tensor(g).to(dtype).requires_grad_(True)
    val = tnn.nn_loss(tp, tg, area, area)
    val.float().backward()
    return val, [tp.grad.float().numpy(), tg.grad.float().numpy()]


@pytest.mark.parametrize("area", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nn_loss_value_and_cotangents_match_jax(dtype, area):
    """The value and both cotangents against ``jax.grad`` of the JAX
    ``nn_loss`` (its custom VJP) on the same (2, 24, 20, 64) features."""
    p, g = _features(area, (2, 24, 20, 64), dtype)
    want, want_grads = _jax_nn(p, g, area, dtype)
    val, got_grads = _port_nn(p, g, area, dtype)
    assert val.dtype == dtype and val.shape == ()
    np.testing.assert_allclose(val.item(), want, rtol=NN_RTOL[dtype])
    for got, ref, what in zip(got_grads, want_grads, ("pred", "gt")):
        assert np.abs(ref).max() > 0, what
        # a pixel's cotangent: the routed shift's signs, scaled
        differ = np.any(got != ref, axis=-1).mean()
        assert differ <= FLIP_SHARE[dtype], (what, differ)


def test_nn_loss_ties_route_to_the_first_shift():
    """Constant features: every in-image shift ties, and the first one in
    scan order that is not padding wins (a strict ``<``), on both sides;
    the index is that shift's number."""
    area = 3
    p = np.full((1, 6, 5, 4), 0.25, np.float32)
    g = np.full((1, 6, 5, 4), 0.5, np.float32)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        val, got = _port_nn(p, g, area, torch.float32)
    idx = saved[2].numpy()
    # the first (i, j) in row-major order whose window lies in the image
    want_idx = np.zeros((6, 5), np.uint8)
    for y in range(6):
        for x in range(5):
            want_idx[y, x] = next(
                k for k, (i, j) in enumerate(
                    (i, j) for i in range(area) for j in range(area))
                if 0 <= y + i - 1 < 6 and 0 <= x + j - 1 < 5)
    np.testing.assert_array_equal(idx[0], want_idx)
    _, want = _jax_nn(p, g, area, torch.float32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert val.item() == pytest.approx(0.25 * 4)


def test_nn_loss_saves_the_inputs_and_one_uint8_map():
    """What the Function keeps for its backward: the two inputs and one
    uint8 (N, H, W) index, nothing per shift; autograd through the plain
    primal keeps tens of tensors at area 5."""
    p, g = _features(0, (2, 10, 8, 16), torch.float32)
    tp = torch.tensor(p, requires_grad=True)
    tg = torch.tensor(g, requires_grad=True)
    for fn, most in ((tnn.nn_loss, 3), (tnn.nn_loss_reference, None)):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            fn(tp, tg, 5, 5)
        if most is None:
            assert len(saved) > 25
            continue
        assert len(saved) == most
        assert saved[0] is tp and saved[1] is tg
        assert saved[2].dtype == torch.uint8 and \
            tuple(saved[2].shape) == (2, 10, 8)


@pytest.mark.parametrize("area", [3, 5])
def test_nn_loss_gradient_equals_autograd_through_the_primal(area):
    """Without ties (random f32 features), the routed backward is
    autograd's through the chain of ``minimum``s, for both inputs: the
    prediction's bit for bit; the target's, which sums up to area² routed
    signs per element in another order than autograd's, within 1e-6 of
    the largest element (measured: 1.9e-9 of 0.1, a few f32 ulps; a sum
    that cancels to 0 in one order may leave an ulp in the other)."""
    p, g = _features(7, (2, 12, 10, 32), torch.float32)
    grads = []
    for fn in (tnn.nn_loss, tnn.nn_loss_reference):
        tp = torch.tensor(p, requires_grad=True)
        tg = torch.tensor(g, requires_grad=True)
        val = fn(tp, tg, area, area)
        val.backward()
        grads.append((val.item(), tp.grad, tg.grad))
    (v1, p1, g1), (v2, p2, g2) = grads
    assert v1 == v2
    assert torch.equal(p1, p2)
    torch.testing.assert_close(g1, g2, rtol=0,
                               atol=1e-6 * g2.abs().max().item())


def test_nn_loss_target_without_grad_gets_none():
    """A training target asks for no cotangent, and gets none."""
    p, g = _features(1, (1, 6, 6, 4), torch.float32)
    tp = torch.tensor(p, requires_grad=True)
    tnn.nn_loss(tp, torch.tensor(g), 3, 3).backward()
    assert tp.grad is not None and tp.grad.abs().max() > 0


def test_vgg_features_promote_bf16_to_f32_like_jax():
    """A bf16 image is rescaled in bf16 and normalised in f32, so the
    content loss's features are f32 in both packages, and agree."""
    jp = jvgg.random_vgg19_features(0)
    vgg = tvgg.VGG19Features()
    vgg.load_state_dict(vgg_state_dict_from_flax(jax.tree.map(np.asarray,
                                                               jp)))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 16, 12, 3)) \
        .astype(np.float32)
    layer = tvgg.get_layer_ind("block1_conv2")
    for mode in ("correct", "reference"):
        want = np.asarray(jvgg.extract_features(
            jp, jnp.asarray(x, jnp.bfloat16), layer, mode))
        got = tvgg.extract_features(vgg, torch.tensor(x).bfloat16(), layer,
                                    mode)
        assert want.dtype == np.float32 and got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_create_state_holds_a_frozen_vgg():
    """With a content loss the state carries a VGG19: random filters of
    seed 0 (or the one given), frozen, in no optimizer and no checkpoint;
    an L1 state carries none."""
    cfg = engine.GANConfig(image_size=SIZE, batch_size=N, check_mode=True,
                           **RECIPE)
    st = engine.create_state(cfg, device="cpu")
    ref = tvgg.random_vgg19_features(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(st.vgg.state_dict().values(), ref.state_dict().values()))
    assert not any(p.requires_grad for p in st.vgg.parameters())
    in_opt = {id(p) for o in (st.gen_opt, st.disc_opt)
              for grp in o.param_groups for p in grp["params"]}
    assert not in_opt & {id(p) for p in st.vgg.parameters()}
    gen_blob, disc_blob = checkpoint._snapshot(st)
    assert not any(k.startswith("features") for k in (*gen_blob, *disc_blob))
    given = tvgg.random_vgg19_features(3, device="cpu")
    assert engine.create_state(cfg, device="cpu", vgg=given).vgg is given
    l1 = engine.create_state(dataclasses.replace(
        cfg, content_loss_layer="none"), device="cpu")
    assert l1.vgg is None


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb_scalars(params):
    """Nonzero norm affines, so that the mapping of every leaf matters."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * (len(jax.tree_util.keystr(path)) % 5)
        if x.ndim == 0 else x, params)


@pytest.fixture(scope="module")
def step_case():
    """Both sides of one dropout-off content-loss step from the same
    generator, discriminator and VGG weights."""
    rng = np.random.default_rng(0)
    fake, real, gen_b = (jsyn.synthetic_compact_batch(rng, N, SIZE, 18)
                         for _ in range(3))
    jcfg = JConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                   warp_windowed=False, **RECIPE)
    jgen = JGen(pose_dim=18, image_size=SIZE, nfilters_enc=ENC,
                nfilters_dec=DEC)
    jdisc = JDisc()
    prep = jprep(image_size=SIZE, pose_dim=18)
    p0 = prep(gen_b)
    gen_params = _np(_perturb_scalars(jgen.init(
        {"params": jax.random.PRNGKey(0)}, p0["input"], p0["warps"],
        p0["masks"], train=False)))
    disc_params = _np(_perturb_scalars(jdisc.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, *SIZE, IN_CH)),
        train=False)))
    vgg_params = _np(jvgg.random_vgg19_features(0))

    # ---- port: one step through make_train_step, dropout off
    cfg = engine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                           warp_windowed=False, **RECIPE)
    gen = networks.DeformableGenerator(18, SIZE, ENC, DEC)
    gen.load_state_dict(generator_state_dict_from_flax(gen_params))
    disc = networks.Discriminator(IN_CH)
    disc.load_state_dict(discriminator_state_dict_from_flax(disc_params))
    vgg = tvgg.VGG19Features()
    vgg.load_state_dict(vgg_state_dict_from_flax(vgg_params))
    vgg.requires_grad_(False)
    state = engine.TrainState(
        gen=gen, disc=disc,
        gen_opt=engine.make_optimizer(cfg, gen.parameters()),
        disc_opt=engine.make_optimizer(cfg, disc.parameters()),
        rng=torch.Generator().manual_seed(0), vgg=vgg)
    calls = []
    real_nn = tnn.NNLoss.apply
    stack = lambda b: {k: v[None] for k, v in b.items()}   # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(networks.ChannelDropout, "forward", lambda self, x: x)
        mp.setattr(tnn.NNLoss, "apply", lambda *a: calls.append(
            (tuple(a[0].shape), a[0].dtype, a[2:])) or real_nn(*a))
        metrics, out_gen = engine.make_train_step(cfg, state)(
            stack(fake), stack(real), gen_b)
    port = {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "out_gen": out_gen.numpy(), "nn_calls": calls,
            "gen_grads": {k: p.grad.clone()
                          for k, p in gen.named_parameters()},
            "disc_grads": {k: p.grad.clone()
                           for k, p in disc.named_parameters()}}

    # ---- JAX: the same step composed from its pieces, train=False
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
        out = jengine.gen_apply(jgen, gp, b, jcfg, train=False)[0]
        d_out = jdisc.apply(dp, jengine.disc_input(b["input"], out, jcfg),
                            train=True)
        ad = jlosses.gen_adversarial_loss(d_out, 1.0, N)
        ll = jengine.reconstruction_loss(out, b["target"], vgg_params,
                                         jcfg) * jcfg.l1_penalty_weight
        return ad + ll, (ll, ad, out)

    (d_total, (d_true, d_fake)), d_grads = jax.jit(jax.value_and_grad(
        disc_loss, has_aux=True))(disc_params, gen_params, prep(fake),
                                  prep(real))
    # the generator phase against the port's updated discriminator (as in
    # tests/test_torch_train.py: Adam's first update is ≈ lr·sign(g))
    disc_new = _np(import_discriminator(
        {k: v.detach().numpy() for k, v in disc.state_dict().items()}))
    (g_total, (ll, ad, out)), g_grads = jax.jit(jax.value_and_grad(
        gen_loss, has_aux=True))(gen_params, disc_new, p0)
    ref = {"metrics": {"gen": np.array([g_total, ll, ad], np.float32),
                       "disc": np.array([d_total, d_true, d_fake],
                                        np.float32)},
           "out_gen": np.asarray(out),
           "gen_grads": generator_state_dict_from_flax(_np(g_grads)),
           "disc_grads": discriminator_state_dict_from_flax(_np(d_grads))}
    return port, ref


def _sd_close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_SCALE * np.abs(w).max(),
                                   err_msg=f"{what}: {k}")
        assert np.abs(w).max() > 0, f"{what}: {k} has no gradient"


def test_content_step_losses_match_jax(step_case):
    """[total, ll, ad] and [total, true, fake]; ll is nn_loss over the
    block1_conv2 features (the VGG's 4th layer, its ReLU), area 5, run once
    in the generator phase on f32 features."""
    port, ref = step_case
    for phase in ("gen", "disc"):
        np.testing.assert_allclose(port["metrics"][phase],
                                   ref["metrics"][phase], rtol=LOSS_RTOL,
                                   err_msg=phase)
    np.testing.assert_allclose(port["out_gen"], ref["out_gen"], atol=1e-4)
    assert port["nn_calls"] == [((N, *SIZE, 64), torch.float32, (5, 5))]


@pytest.mark.parametrize("net", ["gen", "disc"])
def test_content_step_gradients_match_jax(step_case, net):
    port, ref = step_case
    _sd_close(port[f"{net}_grads"], ref[f"{net}_grads"], net)


def test_content_step_trains_from_create_state():
    """Through the entry points (create_state, make_train_step), bf16,
    gaussian init: finite losses, a content loss that is not the L1 one,
    both nets' parameters move and the VGG's do not."""
    cfg = engine.GANConfig(image_size=SIZE, batch_size=N, check_mode=True,
                           compute_dtype=torch.bfloat16,
                           weight_init="gaussian", **RECIPE)
    st = engine.create_state(cfg, seed=1, device="cpu")
    vgg_before = [p.clone() for p in st.vgg.parameters()]
    before = [p.detach().clone() for p in (*st.gen.parameters(),
                                            *st.disc.parameters())]
    rng = np.random.default_rng(3)
    draw = lambda: jsyn.synthetic_compact_batch(rng, N, SIZE, 18)  # noqa
    stack = lambda b: {k: v[None] for k, v in b.items()}   # noqa: E731
    metrics, out = engine.make_train_step(cfg, st)(stack(draw()),
                                                   stack(draw()), draw())
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert out.dtype == torch.bfloat16 and out.shape == (N, *SIZE, 3)
    after = [p.detach() for p in (*st.gen.parameters(),
                                  *st.disc.parameters())]
    assert not any(torch.equal(a, b) for a, b in zip(before, after))
    assert all(torch.equal(a, b) for a, b in zip(vgg_before,
                                                 st.vgg.parameters()))
