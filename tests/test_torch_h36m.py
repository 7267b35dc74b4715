"""Check mode and h36m's pose_dim 16 against the JAX package: the
generator's forward and one two-phase train step from the same weights.

Two cases at 64², batch 2, f32, dropout off on both sides:
- ``check``: the check-mode model (``GANConfig(check_mode=True)``: the
  first 2 encoder stages, a (128, 3) decoder, a discriminator of blocks
  128, 256 and 1),
  pose_dim 18, the auto fold (the full scan on the CPU);
- ``h36m``: pose_dim 16 with a narrow 5-stage generator and the full-width
  discriminator; the 64² stage takes the kernel-placed windowed fold with
  the 5 static-empty parts compacted out (JAX's Pallas kernels in
  interpret mode, the port's plain versions on the CPU).

The JAX step is composed from ``engine.gen_apply(train=False)``,
``disc_input`` and ``losses``, as in tests/test_torch_train.py, whose
tolerances hold here (LOSS_RTOL, GRAD_RTOL, GRAD_SCALE: the convolutions'
and reductions' sums associate differently in XLA and oneDNN).
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
from pose_transfer_tpu.models.import_torch import _conv, _scalar
from pose_transfer_tpu.train import GANConfig as JConfig
from pose_transfer_tpu.train import engine as jengine
from pose_transfer_tpu.train import losses as jlosses
from pose_transfer_torch.models import networks
from pose_transfer_torch.models.import_flax import (
    discriminator_state_dict_from_flax, generator_state_dict_from_flax)
from pose_transfer_torch.ops import warp_fused as twf
from pose_transfer_torch.train import engine

torch.set_num_threads(2)

SIZE = (64, 64)
N = 2
LOSS_RTOL, GRAD_RTOL, GRAD_SCALE = 1e-5, 1e-4, 1e-4
F32_ATOL = 1e-4
NARROW = ((16, 16, 32, 32, 32), (32, 32, 16, 16, 3))


@dataclasses.dataclass(frozen=True)
class Case:
    pose_dim: int
    check_mode: bool
    windowed: bool

    def configs(self):
        kw = dict(image_size=SIZE, pose_dim=self.pose_dim, batch_size=N,
                  check_mode=self.check_mode, warp_windowed=self.windowed)
        return JConfig(**kw, warp_place="kernel"), engine.GANConfig(**kw)

    def jax_models(self, jcfg):
        if self.check_mode:
            return jengine.build_models(jcfg)
        return (JGen(pose_dim=self.pose_dim, image_size=SIZE,
                     nfilters_enc=NARROW[0], nfilters_dec=NARROW[1],
                     warp_windowed=True, warp_place="kernel"), JDisc())

    def filters(self, cfg):
        return cfg.filters if self.check_mode else NARROW


CASES = {"check": Case(18, True, False), "h36m": Case(16, False, True)}


def _perturb_scalars(params):
    """Nonzero norm affines, so that the mapping of every leaf matters."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * (len(jax.tree_util.keystr(path)) % 5)
        if x.ndim == 0 else x, params)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _disc_to_flax(sd):
    """The port's discriminator state_dict as flax params, for any number
    of blocks (``import_torch.import_discriminator(check_mode=True)`` maps
    2 blocks, but the JAX check-mode discriminator has 3)."""
    sd = {k: v.detach().numpy() for k, v in sd.items()}
    p = {"Conv_0": {"kernel": _conv(sd["net.0.weight"]),
                    "bias": sd["net.0.bias"]}}
    i = 1
    while f"net.{i}.net.1.weight" in sd:
        block = {"Conv_0": {"kernel": _conv(sd[f"net.{i}.net.1.weight"])}}
        if f"net.{i}.net.2.weight" in sd:
            block["VolumeInstanceNorm_0"] = {
                "scale": _scalar(sd[f"net.{i}.net.2.weight"]),
                "bias": _scalar(sd[f"net.{i}.net.2.bias"])}
        p[f"Block_{i - 1}"] = block
        i += 1
    return {"params": p}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Both sides of one dropout-off step from the same parameters, and
    the eval forward before it."""
    c = CASES[request.param]
    jcfg, cfg = c.configs()
    jgen, jdisc = c.jax_models(jcfg)
    rng = np.random.default_rng(0)
    fake, real, gen_b = (jsyn.synthetic_compact_batch(rng, N, SIZE,
                                                      c.pose_dim)
                         for _ in range(3))
    prep = jprep(image_size=SIZE, pose_dim=c.pose_dim)
    p0 = prep(gen_b)
    gen_params = _np(_perturb_scalars(jgen.init(
        {"params": jax.random.PRNGKey(0)}, p0["input"], p0["warps"],
        p0["masks"], train=False)))
    disc_params = _np(_perturb_scalars(jdisc.init(
        {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1, *SIZE, cfg.input_nc + 3)), train=False)))

    # ---- port
    enc, dec = c.filters(cfg)
    gen = networks.DeformableGenerator(c.pose_dim, SIZE, enc, dec,
                                       warp_windowed=c.windowed)
    gen.load_state_dict(generator_state_dict_from_flax(gen_params))
    disc = networks.Discriminator(cfg.input_nc + 3, check_mode=c.check_mode)
    disc.load_state_dict(discriminator_state_dict_from_flax(disc_params))
    fwd, _ = engine.make_eval_step(cfg, gen, device="cpu")(gen_b)
    state = engine.TrainState(
        gen=gen, disc=disc,
        gen_opt=engine.make_optimizer(cfg, gen.parameters()),
        disc_opt=engine.make_optimizer(cfg, disc.parameters()),
        rng=torch.Generator().manual_seed(0))
    calls = []
    real_place = twf.fold_place
    stack = lambda b: {k: v[None] for k, v in b.items()}   # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(networks.ChannelDropout, "forward", lambda self, x: x)
        mp.setattr(twf, "fold_place", lambda *a: calls.append(
            a[3].all().item()) or real_place(*a))
        metrics, out_gen = engine.make_train_step(cfg, state)(
            stack(fake), stack(real), gen_b)
    port = {"fwd": fwd.numpy(), "out_gen": out_gen.numpy(),
            "metrics": {k: v.numpy() for k, v in metrics.items()},
            "place_zero_nb_all": calls,
            "gen_grads": {k: p.grad.clone()
                          for k, p in gen.named_parameters()},
            "disc_grads": {k: p.grad.clone()
                           for k, p in disc.named_parameters()}}

    # ---- JAX
    fwd_j = jax.jit(lambda p, b: jengine.gen_apply(
        jgen, p, b, jcfg, train=False)[0])(gen_params, p0)

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
        disc_loss, has_aux=True))(disc_params, gen_params, prep(fake),
                                  prep(real))
    # the generator phase runs against the port's updated discriminator
    disc_new = _disc_to_flax(disc.state_dict())
    (g_total, (ll, ad, out)), g_grads = jax.jit(jax.value_and_grad(
        gen_loss, has_aux=True))(gen_params, disc_new, p0)
    ref = {"fwd": np.asarray(fwd_j), "out_gen": np.asarray(out),
           "metrics": {"gen": np.array([g_total, ll, ad], np.float32),
                       "disc": np.array([d_total, d_true, d_fake],
                                        np.float32)},
           "gen_grads": generator_state_dict_from_flax(_np(g_grads)),
           "disc_grads": discriminator_state_dict_from_flax(_np(d_grads))}
    return c, port, ref


def _sd_close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_SCALE * np.abs(w).max(),
                                   err_msg=f"{what}: {k}")
        assert np.abs(w).max() > 0, f"{what}: {k} has no gradient"


def test_forward_matches_jax(case):
    _, port, ref = case
    assert port["fwd"].shape == ref["fwd"].shape == (N, *SIZE, 3)
    np.testing.assert_allclose(port["fwd"], ref["fwd"], atol=F32_ATOL,
                               rtol=0)


def test_step_losses_and_output_match_jax(case):
    _, port, ref = case
    for phase in ("gen", "disc"):
        np.testing.assert_allclose(port["metrics"][phase],
                                   ref["metrics"][phase], rtol=LOSS_RTOL,
                                   err_msg=phase)
    np.testing.assert_allclose(port["out_gen"], ref["out_gen"],
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("net", ["gen", "disc"])
def test_step_gradients_match_jax(case, net):
    _, port, ref = case
    _sd_close(port[f"{net}_grads"], ref[f"{net}_grads"], net)


def test_fold_path(case):
    """h36m: the windowed stage's placement runs twice per step (the disc
    phase's forward and the gen phase's), and pose_dim 16 puts every pixel
    in the zero pass (its static-empty parts never cover one); the check
    model's auto fold on the CPU is the full scan (no placement)."""
    c, port, _ = case
    want = [True, True] if c.windowed else []
    assert port["place_zero_nb_all"] == want


def test_check_mode_models_have_jax_shapes():
    """The check-mode generator and discriminator: the JAX package's
    parameter shapes, leaf for leaf."""
    jcfg, cfg = CASES["check"].configs()
    jgen, jdisc = jengine.build_models(jcfg)
    state = engine.create_state(cfg, device="cpu")
    p0 = jprep(image_size=SIZE, pose_dim=18)(jsyn.synthetic_compact_batch(
        np.random.default_rng(0), 1, SIZE, 18))
    jg = jax.eval_shape(lambda: jgen.init(
        {"params": jax.random.PRNGKey(0)}, p0["input"], p0["warps"],
        p0["masks"], train=False))
    jd = jax.eval_shape(lambda: jdisc.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, *SIZE, cfg.input_nc + 3)), train=False))
    for net, tree, mapping in (
            (state.gen, jg, generator_state_dict_from_flax),
            (state.disc, jd, discriminator_state_dict_from_flax)):
        want = mapping(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                    tree))
        got = net.state_dict()
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
