"""``warp_backend='exact'`` (the gather-bilinear warp and its fold) against
the JAX package's, and against ``torch.nn.functional.grid_sample``.

Tolerances:
- Against JAX run eagerly (``jax.disable_jit``): the same positions, taps,
  f32 weights, products and sum order, one rounding, so the forwards are
  bit for bit in f32 and bf16, and the f32 feature gradient too. A bf16
  feature gradient is held within 2^-8 of its largest magnitude (measured
  2^-9.8): the gather's transpose adds each tap's cotangent into its
  source pixel in bf16, and JAX's scatter-add and torch's ``index_add``
  add them in other orders.
- Against jitted JAX: XLA:CPU contracts the position and tap-weight
  products into FMAs, which moves a position by an ulp: f32 within 1e-5 of
  the largest magnitude (measured 3.5e-6 forward, 6.5e-8 gradient); bf16
  forwards bit for bit (measured), bf16 gradients within 2^-6 (measured
  2^-7.8). In a whole generator such ulps also crown the other part where
  two parts' values nearly tie, and the cotangent of that pixel then takes
  another route (one element of a conv gradient moved by 1.5e-3 of its
  largest, measured): the generator's gradients are therefore held against
  eager JAX.
- Against ``grid_sample``: the same bilinear function, with the positions
  computed in another way (a normalized affine grid), so f32 rounding of
  the positions moves a sample by up to 1e-5 of the largest magnitude.
- The generator and its step: ``tests/test_torch_train.py``'s tolerances
  (outputs 1e-4, losses 1e-5 relative, gradients 1e-4 relative plus 1e-4
  of each tensor's largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pose_transfer_tpu.data.device import make_batch_preparer as jprep
from pose_transfer_tpu.ops import warp as jwarp
from pose_transfer_tpu.train import GANConfig as JConfig
from pose_transfer_tpu.train import engine as jengine
from pose_transfer_tpu.train import losses as jlosses
from pose_transfer_torch.models import networks
from pose_transfer_torch.models.import_flax import (
    discriminator_params_to_flax, discriminator_state_dict_from_flax,
    generator_state_dict_from_flax)
from pose_transfer_torch.ops import warp as twarp
from pose_transfer_torch.ops import warp_fused, warp_pallas
from pose_transfer_torch.train import engine

from test_torch_train import (LOSS_RTOL, N, SIZE, _batches, _np,
                              _perturb_scalars, _sd_close)

torch.set_num_threads(2)

JIT_F32_REL = 1e-5
BF16_GRAD_REL, JIT_BF16_GRAD_REL = 2.0 ** -8, 2.0 ** -6
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().detach().numpy()


def _warps(rng, n, t, shift=20.0, m10=True):
    """Inverse affines near identity: scale, shear and shifts that move
    samples out of bounds; ``m10=False`` zeroes the vertical shear."""
    w = np.zeros((n, t, 8), np.float32)
    w[..., 0] = w[..., 4] = 1.0
    w[..., :6] += rng.normal(0.0, 0.2, (n, t, 6))
    w[..., 2] *= shift
    w[..., 5] *= shift
    if not m10:
        w[..., 3] = 0.0
    return w


def _inputs(seed, n=2, h=32, w=24, c=8, t=6, img=(64, 48)):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, h, w, c)).astype(np.float32)
    warps = _warps(rng, n, t)
    masks = (rng.random((n, t, *img)) < 0.6).astype(np.float32)
    f[:, :h // 3, :w // 3] = 0.0         # where every tap reads 0
    masks[:, 2] = 0.0                    # zero-mask parts: ties at 0
    masks[0, 4] = 0.0
    warps[:, 5], masks[:, 5] = warps[:, 1], masks[:, 1]   # a tied part
    return f, warps, masks, img


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bilinear_sample_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    img = rng.standard_normal((3, 9, 7, 5)).astype(np.float32)
    v = rng.uniform(-2.5, 10.5, (3, 6, 4)).astype(np.float32)
    u = rng.uniform(-2.5, 8.5, (3, 6, 4)).astype(np.float32)
    v[0, 0, 0], u[0, 0, 0] = 3.0, 2.0              # an integer position
    got = twarp.bilinear_sample(torch.tensor(img).to(tdt), torch.tensor(v),
                                torch.tensor(u))
    assert got.dtype == tdt and tuple(got.shape) == (3, 6, 4, 5)
    for i in range(3):
        want = jwarp.bilinear_sample(jnp.asarray(img[i]).astype(jdt),
                                     jnp.asarray(v[i]), jnp.asarray(u[i]))
        np.testing.assert_array_equal(_f32(got[i]), _f32(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_warp_feature_single_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    f, warps, _, img = _inputs(1)
    got = twarp.warp_feature_single(torch.tensor(f).to(tdt),
                                    torch.tensor(warps[:, 1]).to(tdt), img)
    for i in range(len(f)):
        args = (jnp.asarray(f[i]).astype(jdt),
                jnp.asarray(warps[i, 1]).astype(jdt))
        eager = jwarp.warp_feature_single(*args, img)
        np.testing.assert_array_equal(_f32(got[i]), _f32(eager))
        jit = jax.jit(jwarp.warp_feature_single, static_argnums=2)(*args,
                                                                   img)
        scale = np.abs(_f32(jit)).max()
        np.testing.assert_allclose(_f32(got[i]), _f32(jit), rtol=0,
                                   atol=JIT_F32_REL * scale
                                   if dtype == "float32" else 0)


def test_warp_feature_single_matches_grid_sample():
    """``F.grid_sample`` (bilinear, zero padding, align_corners=False) on
    the normalized affine grid of the same pixel-space transform."""
    f, warps, _, img = _inputs(2, h=40, w=40, c=4, img=(40, 40))
    n, h, w, _ = f.shape
    got = twarp.warp_feature_single(torch.tensor(f), torch.tensor(
        warps[:, 0]), img).numpy()
    m00, m01, tx, m10, m11, ty = (warps[:, 0, k].astype(np.float64)
                                  for k in range(6))
    theta = np.stack([
        np.stack([m00, m01 * h / w, m00 + m01 * h / w + 2 * tx / w - 1], 1),
        np.stack([m10 * w / h, m11, m10 * w / h + m11 + 2 * ty / h - 1], 1),
    ], 1)
    grid = F.affine_grid(torch.tensor(theta), (n, 1, h, w),
                         align_corners=False)
    want = F.grid_sample(torch.tensor(f, dtype=torch.float64)
                         .permute(0, 3, 1, 2), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=False)
    want = want.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert (np.abs(want) > 0).mean() > 0.5


def _layer(f, warps, masks, img, dtype, agg="max"):
    tdt, jdt = DTYPES[dtype]
    ft = torch.tensor(f).to(tdt).requires_grad_(True)
    out = twarp.affine_transform_layer(ft, torch.tensor(warps).to(tdt),
                                       torch.tensor(masks), img,
                                       warp_agg=agg, backend="exact")
    g = np.random.default_rng(9).standard_normal(out.shape) \
        .astype(np.float32)
    out.backward(torch.tensor(g).to(tdt))

    def jfold(x):
        return jwarp.affine_transform_layer(
            x, jnp.asarray(warps).astype(jdt), jnp.asarray(masks), img,
            "mask", agg, backend="exact")

    jf = jnp.asarray(f).astype(jdt)
    want = jfold(jf)
    jg = jax.grad(lambda x: jnp.sum(jfold(x).astype(jnp.float32)
                                    * jnp.asarray(g).astype(jdt)
                                    .astype(jnp.float32)))(jf)
    return out, ft.grad, want, jg


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_exact_fold_forward_and_gradient_match_jax(dtype, jit):
    """With a zero region of the features and zero-mask parts (parts tie
    at exactly 0 there) and two identical parts: ``torch.maximum``'s chain
    splits a tie's cotangent in half at each step as ``jnp.maximum``'s
    does."""
    f, warps, masks, img = _inputs(3)
    if jit:
        out, grad, want, jg = _layer(f, warps, masks, img, dtype)
    else:
        with jax.disable_jit():
            out, grad, want, jg = _layer(f, warps, masks, img, dtype)
    assert out.dtype == DTYPES[dtype][0]
    scale = np.abs(_f32(jg)).max()
    if dtype == "bfloat16" or not jit:
        np.testing.assert_array_equal(_f32(out), _f32(want))
    else:
        np.testing.assert_allclose(_f32(out), _f32(want), rtol=0,
                                   atol=JIT_F32_REL * np.abs(_f32(want))
                                   .max())
    atol = {("float32", False): 0.0, ("float32", True): JIT_F32_REL,
            ("bfloat16", False): BF16_GRAD_REL,
            ("bfloat16", True): JIT_BF16_GRAD_REL}[dtype, jit] * scale
    np.testing.assert_allclose(_f32(grad), _f32(jg), rtol=0, atol=atol)
    if dtype == "bfloat16":
        return
    # the ties matter: ``amax`` over a stack of the parts, which splits a
    # tie evenly among all its parts, gives another gradient
    x = torch.tensor(f).requires_grad_(True)
    masks_r = twarp.resize_bilinear(torch.tensor(masks), f.shape[1:3])
    warped = torch.stack([
        twarp.warp_feature_single(x, torch.tensor(warps[:, i]), img)
        * masks_r[:, i][..., None] for i in range(warps.shape[1])])
    g = np.random.default_rng(9).standard_normal(f.shape).astype(np.float32)
    warped.amax(0).backward(torch.tensor(g))
    assert np.abs(x.grad.numpy() - _f32(jg)).max() > 0.01 * scale


def test_exact_fold_avg_matches_jax():
    f, warps, masks, img = _inputs(4)
    with jax.disable_jit():
        out, grad, want, jg = _layer(f, warps, masks, img, "float32", "avg")
    np.testing.assert_array_equal(_f32(out), _f32(want))
    np.testing.assert_array_equal(_f32(grad), _f32(jg))


def test_exact_equals_the_two_pass_warp_without_vertical_shear():
    """With m10 = 0 the two-pass resample evaluates each tap where the
    direct one does: the 'exact' and 'matmul' folds agree (f32, to the
    summation order of the banded products)."""
    f, warps, masks, img = _inputs(5)
    warps[..., 3] = 0.0
    args = (torch.tensor(f), torch.tensor(warps), torch.tensor(masks), img)
    exact = twarp.affine_transform_layer(*args, backend="exact")
    matmul = twarp.affine_transform_layer(*args, backend="matmul")
    np.testing.assert_allclose(exact.numpy(), matmul.numpy(), rtol=0,
                               atol=1e-5 * np.abs(matmul.numpy()).max())


def test_exact_plans_no_windows_and_launches_nothing(monkeypatch):
    f, warps, masks, img = _inputs(6, h=64, w=48)
    plans = twarp.plan_folds([f.shape], torch.tensor(warps),
                             torch.tensor(masks), torch.float32,
                             windowed=True, backend="exact")
    assert plans[0].branch == "exact" and plans[0].windows is None
    for mod, name in ((warp_fused, "fold_place"), (warp_fused, "fold_route"),
                      (warp_pallas, "warp_fold")):
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail(name))
    x = torch.tensor(f).requires_grad_(True)
    twarp.affine_transform_layer(x, torch.tensor(warps), torch.tensor(masks),
                                 img, windowed=True, backend="exact") \
        .sum().backward()
    assert torch.isfinite(x.grad).all()


def test_unknown_backend_raises():
    f, warps, _, _ = _inputs(7)
    with pytest.raises(ValueError, match="invalid warp backend"):
        twarp.plan_folds([f.shape], torch.tensor(warps), None,
                         torch.float32, "full", backend="gather")
    with pytest.raises(ValueError, match="invalid warp backend"):
        engine.build_models(engine.GANConfig(warp_backend="gather"),
                            device="cpu")


# --------------------------------------------------- generator and a step

def test_exact_generator_forward_and_step_match_jax():
    """The check-mode 64² generator and discriminator with
    ``warp_backend='exact'``, from the same parameters and batches, dropout
    off: the forward and the discriminator phase against jitted JAX (both
    continuous in the fold's values), the generator phase's gradients,
    which the fold routes by its argmax, against eager JAX."""
    fake, real, gen_b = _batches(3)
    jcfg = JConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                   warp_backend="exact", check_mode=True)
    jstate, jgen, jdisc = jengine.create_state(jcfg, seed=2)
    gen_params = _np(_perturb_scalars(jstate.gen_params))
    disc_params = _np(_perturb_scalars(jstate.disc_params))
    prep = jprep(image_size=SIZE, pose_dim=18)

    cfg = engine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                           warp_backend="exact", check_mode=True)
    state = engine.create_state(cfg, device="cpu")
    gen, disc = state.gen, state.disc
    gen.load_state_dict(generator_state_dict_from_flax(gen_params))
    disc.load_state_dict(discriminator_state_dict_from_flax(disc_params))

    fwd, _ = engine.make_eval_step(cfg, gen, "cpu")(gen_b)
    want = np.asarray(jengine.make_eval_step(jcfg, jgen)(gen_params,
                                                         gen_b)[0])
    np.testing.assert_allclose(fwd.numpy(), want, atol=1e-4, rtol=0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(networks.ChannelDropout, "forward", lambda self, x: x)
        metrics, out_gen = engine.make_train_step(cfg, state)(fake, real,
                                                              gen_b)
    gen_grads = {k: p.grad.clone() for k, p in gen.named_parameters()}
    disc_grads = {k: p.grad.clone() for k, p in disc.named_parameters()}

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
        ll = jlosses.l1_loss(out, b["target"]) * 100.0
        return ad + ll, (ll, ad, out)

    (d_total, (d_true, d_fake)), d_grads = jax.jit(jax.value_and_grad(
        disc_loss, has_aux=True))(
            disc_params, gen_params, prep({k: v[0] for k, v in fake.items()}),
            prep({k: v[0] for k, v in real.items()}))
    # the generator phase against the port's updated discriminator (as in
    # tests/test_torch_train.py: Adam's first update is ≈ lr·sign(g)); the
    # check-mode discriminator through the port's inverse map (JAX's
    # importer maps 2 of its 3 blocks)
    disc_new = discriminator_params_to_flax(disc.state_dict())
    batch = prep(gen_b)
    with jax.disable_jit():
        (g_total, (ll, ad, out)), g_grads = jax.value_and_grad(
            gen_loss, has_aux=True)(gen_params, disc_new, batch)
    np.testing.assert_allclose(metrics["gen"].numpy(),
                               np.array([g_total, ll, ad], np.float32),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["disc"].numpy(),
                               np.array([d_total, d_true, d_fake],
                                        np.float32), rtol=LOSS_RTOL)
    np.testing.assert_allclose(out_gen.numpy(), np.asarray(out), atol=1e-4)
    _sd_close(gen_grads, generator_state_dict_from_flax(_np(g_grads)), "gen")
    _sd_close(disc_grads, discriminator_state_dict_from_flax(_np(d_grads)),
              "disc")


def test_exact_config_runs_through_create_state():
    """``GANConfig(warp_backend='exact')`` builds, steps and serves (the
    refusal of earlier slices is gone)."""
    cfg = engine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                           warp_backend="exact", check_mode=True)
    state = engine.create_state(cfg, device="cpu")
    assert state.gen.folds.backend == "exact"
    metrics, out = engine.make_train_step(cfg, state)(*_batches(4))
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert tuple(out.shape) == (N, *SIZE, 3)
