"""The port's training slice against the JAX package's: discriminator,
losses, channel dropout, Adam and one two-phase GAN step.

One step at 64² (pose_dim 18, batch 2, f32) with a narrow generator and the
full-width discriminator, from the same parameters (carried across by
``models.import_flax``) and the same compact batches, dropout off on both
sides. The JAX step is composed from ``engine.gen_apply(..., train=False)``,
``disc_input``, ``losses`` and ``optax.adam`` — the body of its
``make_train_step``. The 64² fold stage takes the kernel-placed windowed
fold on both sides (JAX's Pallas kernels in interpret mode, the port's plain
versions on the CPU), the 32², 16² and 8² stages the full scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pose_transfer_tpu.data import synthetic as jsyn
from pose_transfer_tpu.data.device import make_batch_preparer as jprep
from pose_transfer_tpu.models import DeformableGenerator as JGen
from pose_transfer_tpu.models import Discriminator as JDisc
from pose_transfer_tpu.models.import_torch import import_discriminator
from pose_transfer_tpu.train import GANConfig as JConfig
from pose_transfer_tpu.train import engine as jengine
from pose_transfer_tpu.train import losses as jlosses
from pose_transfer_torch.models import networks
from pose_transfer_torch.models.import_flax import (
    discriminator_state_dict_from_flax, generator_state_dict_from_flax)
from pose_transfer_torch.ops import warp_fused as twf
from pose_transfer_torch.train import engine, losses

torch.set_num_threads(2)

SIZE = (64, 64)
N = 2
ENC = (16, 16, 32, 32, 32)
DEC = (32, 32, 16, 16, 3)
IN_CH = 3 + 2 * 18 + 3          # discriminator input channels
# f32 on both sides: convolutions, einsums and reductions are associated
# differently by XLA and oneDNN (~1e-6 relative per layer), and the
# generator output already differs by ~1e-6; through a whole backward the
# gradients differ by up to ~1e-5 of each tensor's largest entry (measured),
# so an element near zero is held against the tensor's scale:
# |got - want| <= GRAD_RTOL·|want| + GRAD_SCALE·max|want|
LOSS_RTOL, GRAD_RTOL, GRAD_SCALE = 1e-5, 1e-4, 1e-4


def _jgen():
    return JGen(pose_dim=18, image_size=SIZE, nfilters_enc=ENC,
                nfilters_dec=DEC, warp_windowed=True, warp_place="kernel")


def _tgen(params=None):
    gen = networks.DeformableGenerator(18, SIZE, ENC, DEC,
                                       warp_windowed=True)
    if params is not None:
        gen.load_state_dict(generator_state_dict_from_flax(params))
    return gen


def _tdisc(params=None, check_mode=False):
    disc = networks.Discriminator(IN_CH, check_mode=check_mode)
    if params is not None:
        disc.load_state_dict(discriminator_state_dict_from_flax(params))
    return disc


def _perturb_scalars(params):
    """Nonzero norm affines, so that the mapping of every leaf matters."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * (len(jax.tree_util.keystr(path)) % 5)
        if x.ndim == 0 else x, params)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _state(cfg, gen, disc, seed=0):
    rng = torch.Generator()
    rng.manual_seed(seed)
    return engine.TrainState(
        gen=gen, disc=disc,
        gen_opt=engine.make_optimizer(cfg, gen.parameters()),
        disc_opt=engine.make_optimizer(cfg, disc.parameters()), rng=rng)


def _batches(seed):
    rng = np.random.default_rng(seed)
    fake, real, gen_b = (jsyn.synthetic_compact_batch(rng, N, SIZE, 18)
                         for _ in range(3))
    stack = lambda b: {k: v[None] for k, v in b.items()}   # noqa: E731
    return stack(fake), stack(real), gen_b


def _sd_close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_SCALE * np.abs(w).max(),
                                   err_msg=f"{what}: {k}")
        assert np.abs(w).max() > 0, f"{what}: {k} has no gradient"


# ------------------------------------------------------------ discriminator

def test_discriminator_param_count_full_width():
    """The fashion discriminator has the reference's 2 803 782 parameters
    under the reference state_dict names."""
    disc = networks.Discriminator(IN_CH, device="meta")
    assert sum(p.numel() for p in disc.parameters()) == 2_803_782
    names = set(disc.state_dict())
    assert {"net.0.weight", "net.0.bias", "net.1.net.1.weight",
            "net.1.net.2.weight", "net.3.net.2.bias",
            "net.4.net.1.weight"} <= names
    assert not any(k.startswith("net.4.net.2") for k in names)


@pytest.mark.parametrize("check_mode", [False, True])
def test_discriminator_matches_jax(check_mode):
    jd = JDisc(check_mode=check_mode)
    x = np.random.default_rng(0).uniform(-1, 1, (N, *SIZE, IN_CH)) \
        .astype(np.float32)
    params = _np(_perturb_scalars(jd.init(
        {"params": jax.random.PRNGKey(1)}, jnp.asarray(x), train=False)))
    ref = np.asarray(jd.apply(params, jnp.asarray(x), train=True))
    disc = _tdisc(params, check_mode).train()
    got = disc(torch.tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5, rtol=0)
    if not check_mode:
        # the port's names read back through JAX's reference importer
        back = _np(import_discriminator(
            {k: v.numpy() for k, v in disc.state_dict().items()}))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)


def test_discriminator_bf16_sigmoid_in_f32():
    disc = _tdisc()
    disc.dtype = torch.bfloat16
    out = disc(torch.zeros((1, *SIZE, IN_CH)))
    assert out.dtype == torch.float32 and out.shape == (1, 1)


# ------------------------------------------------------------------- losses

def test_losses_match_jax():
    rng = np.random.default_rng(1)
    p_real = rng.uniform(0, 1, (4, 9)).astype(np.float32)
    p_fake = rng.uniform(0, 1, (4, 9)).astype(np.float32)
    p_fake[0, 0], p_real[0, 0] = 1.0, 0.0          # the EPS matters
    a = rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    pairs = [
        (losses.gen_adversarial_loss(torch.tensor(p_fake), 1.5, 4),
         jlosses.gen_adversarial_loss(jnp.asarray(p_fake), 1.5, 4)),
        *zip(losses.disc_adversarial_loss(torch.tensor(p_real),
                                          torch.tensor(p_fake), 1.5, 4),
             jlosses.disc_adversarial_loss(jnp.asarray(p_real),
                                           jnp.asarray(p_fake), 1.5, 4)),
        (losses.l1_loss(torch.tensor(a), torch.tensor(b)),
         jlosses.l1_loss(jnp.asarray(a), jnp.asarray(b))),
        (losses.total_variation_loss(torch.tensor(a)),
         jlosses.total_variation_loss(jnp.asarray(a))),
    ]
    for got, ref in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    # bf16 probabilities are upcast before the EPS and the log
    pb = torch.tensor(p_fake).bfloat16()
    got = losses.disc_adversarial_loss(pb, pb, 1.0, 4)
    ref = jlosses.disc_adversarial_loss(jnp.asarray(p_fake, jnp.bfloat16),
                                        jnp.asarray(p_fake, jnp.bfloat16),
                                        1.0, 4)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)


# ------------------------------------------------------------------ dropout

def test_channel_dropout_distribution():
    """Whole (sample, channel) planes: kept with probability 0.5 and scaled
    ×2, as flax's Dropout(0.5, broadcast_dims=(1, 2)) — whose kept share on
    the same shape is held to the same band (the two draw different
    bits)."""
    drop = networks.ChannelDropout(0.5)
    drop.generator = torch.Generator().manual_seed(0)
    x = torch.ones((64, 64, 4, 4))
    out = drop.train()(x)
    planes = out.reshape(64, 64, 16)
    assert (planes == planes[..., :1]).all()           # whole channels
    assert set(planes[..., 0].unique().tolist()) == {0.0, 2.0}
    kept = (planes[..., 0] == 2.0).float().mean().item()
    import flax.linen as fnn
    jout = fnn.Dropout(0.5, broadcast_dims=(1, 2), deterministic=False).apply(
        {}, jnp.ones((64, 4, 4, 64)), rngs={"dropout": jax.random.PRNGKey(0)})
    jkept = float((np.asarray(jout)[:, 0, 0, :] == 2.0).mean())
    assert set(np.unique(np.asarray(jout)).tolist()) == {0.0, 2.0}
    for share in (kept, jkept):
        assert 0.45 <= share <= 0.55, share
    assert torch.equal(drop.eval()(x), x)


# ------------------------------------------------------------- train step

@pytest.fixture(scope="module")
def step_case():
    """Both sides of one dropout-off step from the same parameters."""
    fake, real, gen_b = _batches(0)
    jcfg = JConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                   warp_windowed=True, warp_place="kernel")
    jgen, jdisc = _jgen(), JDisc()
    prep = jprep(image_size=SIZE, pose_dim=18)
    p0 = prep(gen_b)
    gen_params = _np(_perturb_scalars(jgen.init(
        {"params": jax.random.PRNGKey(0)}, p0["input"], p0["warps"],
        p0["masks"], train=False)))
    disc_params = _np(_perturb_scalars(jdisc.init(
        {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1, *SIZE, IN_CH)), train=False)))

    # ---- port: one step, dropout off, counting the fold kernels' calls
    cfg = engine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                           warp_windowed=True)
    gen, disc = _tgen(gen_params), _tdisc(disc_params)
    state = _state(cfg, gen, disc)
    calls = []
    real_place, real_route = twf.fold_place, twf.fold_route
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(networks.ChannelDropout, "forward", lambda self, x: x)
        mp.setattr(twf, "fold_place", lambda *a: calls.append(
            ("place", a[-1])) or real_place(*a))
        mp.setattr(twf, "fold_route", lambda *a: calls.append(
            ("route",)) or real_route(*a))
        metrics, out_gen = engine.make_train_step(cfg, state)(
            fake, real, gen_b)
    port = {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "out_gen": out_gen.numpy(), "calls": calls, "state": state,
            "gen_grads": {k: p.grad.clone()
                          for k, p in gen.named_parameters()},
            "disc_grads": {k: p.grad.clone()
                           for k, p in disc.named_parameters()}}

    # ---- JAX: the same step composed from its pieces, train=False
    tx = optax.adam(2e-4, b1=0.5, b2=0.999, eps=1e-8)

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

    first = {k: v[0] for k, v in fake.items()}
    (d_total, (d_true, d_fake)), d_grads = jax.jit(jax.value_and_grad(
        disc_loss, has_aux=True))(disc_params, gen_params, prep(first),
                                  prep({k: v[0] for k, v in real.items()}))
    # the generator phase runs against the port's updated discriminator,
    # so that Adam's ≈ lr·sign(g) first update of near-zero gradients does
    # not enter the comparison (Adam is compared on its own below)
    disc_new = _np(import_discriminator(
        {k: v.detach().numpy() for k, v in disc.state_dict().items()}))
    (g_total, (ll, ad, out)), g_grads = jax.jit(jax.value_and_grad(
        gen_loss, has_aux=True))(gen_params, disc_new, prep(gen_b))
    ref = {"metrics": {"gen": np.array([g_total, ll, ad], np.float32),
                       "disc": np.array([d_total, d_true, d_fake],
                                        np.float32)},
           "out_gen": np.asarray(out),
           "gen_grads": generator_state_dict_from_flax(_np(g_grads)),
           "disc_grads": discriminator_state_dict_from_flax(_np(d_grads)),
           "disc_params": disc_params, "tx": tx}
    return port, ref


def test_train_step_losses_match_jax(step_case):
    port, ref = step_case
    for phase in ("gen", "disc"):
        np.testing.assert_allclose(port["metrics"][phase],
                                   ref["metrics"][phase], rtol=LOSS_RTOL,
                                   err_msg=phase)
    np.testing.assert_allclose(port["out_gen"], ref["out_gen"], atol=1e-4)
    assert port["state"].step == 1


def test_train_step_disc_gradients_match_jax(step_case):
    """The discriminator phase's gradients (the generator phase adds none
    to them)."""
    port, ref = step_case
    _sd_close(port["disc_grads"], ref["disc_grads"], "disc")


def test_train_step_gen_gradients_match_jax(step_case):
    """The generator phase's gradients, through the fold's backward."""
    port, ref = step_case
    _sd_close(port["gen_grads"], ref["gen_grads"], "gen")


def test_train_step_fold_kernel_calls(step_case):
    """Disc phase: the generator forward without the argmax (one windowed
    stage, no route); gen phase: with the argmax, and one route in its
    backward."""
    port, _ = step_case
    assert port["calls"] == [("place", False), ("place", True), ("route",)]


def test_adam_matches_optax(step_case):
    """The same gradients in, two Adam updates: the parameters agree to
    1e-6 relative. Compared on their own because a first-step update is
    ≈ lr·sign(g): an error in g would hide behind a compared step. Each
    update is at most lr; its bias corrections 1 - β^t cancel in f32, which
    torch and optax arrange differently (measured ≤ 1e-5 of the update), so
    an entry that starts at zero (the biases) is also allowed 2e-5 of the
    two updates' size."""
    _, ref = step_case
    tx, params = ref["tx"], ref["disc_params"]
    grads = jax.tree.map(lambda p: np.random.default_rng(p.size)
                         .standard_normal(p.shape).astype(np.float32) * 1e-2,
                         params)
    opt_state = tx.init(params)
    jp = params
    disc = _tdisc(params)
    cfg = engine.GANConfig()
    opt = engine.make_optimizer(cfg, disc.parameters())
    sd_grads = discriminator_state_dict_from_flax(grads)
    for k in range(2):
        g = jax.tree.map(lambda x: x * (1.0 + k), grads)
        upd, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in disc.named_parameters():
            p.grad = sd_grads[name] * (1.0 + k)
        opt.step()
    want = discriminator_state_dict_from_flax(_np(jp))
    for name, p in disc.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6,
                                   atol=2e-5 * 2 * cfg.learning_rate,
                                   err_msg=name)


def test_train_step_same_seed_same_step():
    """Dropout on: the same seeds give the same step twice, bit for bit;
    another dropout seed gives another step; both nets' parameters move."""
    fake, real, gen_b = _batches(1)
    cfg = engine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                           warp_windowed=True)

    def run(drop_seed):
        torch.manual_seed(0)
        gen, disc = _tgen(), _tdisc()
        g = torch.Generator().manual_seed(0)
        networks.init_weights(gen, g)
        networks.init_weights(disc, g)
        before = [p.detach().clone() for p in (*gen.parameters(),
                                                *disc.parameters())]
        state = _state(cfg, gen, disc, drop_seed)
        metrics, out = engine.make_train_step(cfg, state)(fake, real, gen_b)
        after = [p.detach() for p in (*gen.parameters(),
                                      *disc.parameters())]
        return metrics, out, before, after, gen.training

    m1, o1, b1, a1, training = run(0)
    m2, o2, _, a2, _ = run(0)
    m3, _, _, _, _ = run(1)
    assert training
    assert all(torch.equal(m1[k], m2[k]) for k in m1) and torch.equal(o1, o2)
    assert all(torch.equal(x, y) for x, y in zip(a1, a2))
    assert not torch.equal(m1["gen"], m3["gen"])
    n_gen = len(list(_tgen().parameters()))
    assert not any(torch.equal(x, y) for x, y in zip(b1, a1)), \
        "every parameter moves on the first Adam step"
    assert len(a1) > n_gen
    assert all(torch.isfinite(m1[k]).all() for k in m1)


def test_eval_step_resets_eval_mode():
    """A trainer leaves the generator in train mode; the eval step puts it
    back in eval mode on every call (dropout off: equal outputs)."""
    cfg = engine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                           warp_windowed=True)
    gen = _tgen()
    step = engine.make_eval_step(cfg, gen, device="cpu")
    batch = jsyn.synthetic_compact_batch(np.random.default_rng(2), N, SIZE,
                                         18)
    gen.train()
    out1, _ = step(batch)
    assert not gen.training
    gen.train()
    out2, _ = step(batch)
    assert torch.equal(out1, out2)
