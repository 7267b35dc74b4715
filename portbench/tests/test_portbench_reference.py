"""The plain reference against the program on the CPU, in float32 at small
sizes: the served images, one training step, and the parameter layout at
the cells' full sizes."""

import numpy as np
import pytest
import torch

from portbench import check, synthetic
from portbench.reference import fits
from portbench.reference import model as ref
from portbench.reference import train as ref_train
from portbench.weights import make_weights

SMALL = [((64, 64), 18), ((64, 64), 16)]


def _requests(seed, size, k, n):
    rng = np.random.default_rng(seed)
    return [synthetic.request(rng, size, k) for _ in range(n)]


@pytest.mark.parametrize("size,k", SMALL)
def test_served_images_match(size, k):
    from pose_transfer_torch.serve import PoseTransferServer
    from pose_transfer_torch.train.engine import GANConfig, build_models
    cfg = GANConfig(image_size=size, pose_dim=k, batch_size=2,
                    warp_windowed=True)
    gen = build_models(cfg, seed=0, device="cpu")
    w = make_weights(ref.generator_spec(size, k), 3, "cpu")
    gen.load_state_dict(w)
    reqs = _requests(1, size, k, 3)
    with PoseTransferServer(cfg, gen, device="cpu") as srv:
        got = torch.as_tensor(srv.generate(reqs))
    samples = []
    for image, a, b in reqs:
        warps, polys, kinds = fits.fit(a, b, k, size)
        samples.append({"image_from": image, "kp_from": a, "kp_to": b,
                        "warps": warps, "mask_polys": polys,
                        "mask_kinds": kinds})
    batch = {key: np.stack([s[key] for s in samples]) for key in samples[0]}
    with torch.no_grad():
        want = ref.generator(w, ref.prepare(batch, size, "cpu"), size, k)
    assert check.image_gaps(got, want).max() < 1e-5


@pytest.mark.parametrize("size,k", SMALL)
def test_training_step_matches(size, k):
    from pose_transfer_torch.train.engine import (
        GANConfig, create_state, make_train_step)
    cfg = GANConfig(image_size=size, pose_dim=k, batch_size=2,
                    warp_windowed=True)
    state = create_state(cfg, seed=0, device="cpu")
    gw = make_weights(ref.generator_spec(size, k), 5, "cpu")
    dw = make_weights(ref.discriminator_spec(k), 6, "cpu")
    state.gen.load_state_dict(gw)
    state.disc.load_state_dict(dw)
    state.rng.manual_seed(77)
    step = make_train_step(cfg, state)
    rng = np.random.default_rng(2)
    fake, real, gen_b = (synthetic.compact_batch(rng, 2, size, k)
                         for _ in range(3))
    metrics, _ = step({kk: v[None] for kk, v in fake.items()},
                      {kk: v[None] for kk, v in real.items()}, gen_b)
    gp, dp = dict(gw), dict(dw)
    out = ref_train.train_step(
        gp, dp, ref_train.Adam(2e-4), ref_train.Adam(2e-4),
        *(ref.prepare(b, size, "cpu") for b in (fake, real, gen_b)),
        ref_train.Recipe(size, k), torch.Generator().manual_seed(77))
    losses = metrics["disc"].tolist() + metrics["gen"].tolist()
    assert check.loss_gap([losses], [out["disc"] + out["gen"]]) < 1e-5
    grads = {**{"gen." + n: state.gen_opt.state[p]["exp_avg"] / 0.5
                for n, p in state.gen.named_parameters()},
             **{"disc." + n: state.disc_opt.state[p]["exp_avg"] / 0.5
                for n, p in state.disc.named_parameters()}}
    ref_grads = {**{"gen." + n: g for n, g in out["gen_grads"].items()},
                 **{"disc." + n: g for n, g in out["disc_grads"].items()}}
    keep = check.kept_leaves(ref_grads)
    # the generator's gradients follow the discriminator's first Adam
    # update, ±lr on any element: where the discriminator's gradient is
    # near zero, rounding picks the sign, and that moves them by ~1e-3
    assert check.norm_gap(grads, ref_grads, keep)[0] < 1e-2
    assert check.diff_gap(grads, ref_grads, keep) < 1e-2
    after = {**{"gen." + n: p for n, p in state.gen.named_parameters()},
             **{"disc." + n: p for n, p in state.disc.named_parameters()}}
    ref_after = {**{"gen." + n: p for n, p in gp.items()},
                 **{"disc." + n: p for n, p in dp.items()}}
    base = {**{"gen." + n: p for n, p in gw.items()},
            **{"disc." + n: p for n, p in dw.items()}}
    delta = {n: after[n].detach() - base[n] for n in after}
    ref_delta = {n: ref_after[n] - base[n] for n in after}
    assert check.norm_gap(delta, ref_delta, keep)[0] < 1e-2


@pytest.mark.parametrize("size,k", [((256, 256), 18), ((224, 224), 16)])
def test_parameters_named_and_shaped_as_the_program(size, k):
    from pose_transfer_torch.train.engine import GANConfig, create_state
    state = create_state(GANConfig(image_size=size, pose_dim=k), 0, "cpu")
    for module, spec in ((state.gen, ref.generator_spec(size, k)),
                         (state.disc, ref.discriminator_spec(k))):
        shapes = {n: tuple(t.shape) for n, t in module.state_dict().items()}
        assert shapes == {n: tuple(s) for n, s, _ in spec}


def test_affines_in_the_compute_dtype_move_the_samples():
    size, k = (64, 64), 18
    w = make_weights(ref.generator_spec(size, k), 3, "cpu")
    rng = np.random.default_rng(4)
    batch = synthetic.compact_batch(rng, 2, size, k)
    prep = ref.prepare(batch, size, "cpu")
    with torch.no_grad():
        f32 = ref.generator(w, prep, size, k)
        bf16 = ref.generator(w, prep, size, k, affine_dtype=torch.bfloat16)
    assert 0 < check.image_gaps(bf16, f32).max() < 0.5


def test_fp8_control_rounds_and_passes_gradients():
    x = torch.linspace(-3.0, 5.0, 101, requires_grad=True)
    y = check.fp8(x)
    assert not torch.equal(y.detach(), x.detach())
    assert (y.detach() - x.detach()).abs().max() <= 5.0 / 8
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_loss_over_half_the_rows_keeps_the_output_and_turns_the_gradient():
    size, k = (64, 64), 18
    gw = make_weights(ref.generator_spec(size, k), 5, "cpu")
    dw = make_weights(ref.discriminator_spec(k), 6, "cpu")
    rng = np.random.default_rng(2)
    batches = [ref.prepare(synthetic.compact_batch(rng, 4, size, k), size,
                           "cpu") for _ in range(3)]
    outs = []
    for rows in (None, 2):
        outs.append(ref_train.train_step(
            dict(gw), dict(dw), ref_train.Adam(2e-4), ref_train.Adam(2e-4),
            *batches, ref_train.Recipe(size, k),
            torch.Generator().manual_seed(7), loss_rows=rows))
    whole, half = outs
    assert torch.equal(whole["out"], half["out"])
    grads = [{**o["gen_grads"], **{"d." + n: g for n, g in
                                    o["disc_grads"].items()}} for o in outs]
    keep = check.kept_leaves(grads[0])
    assert check.diff_gap(grads[1], grads[0], keep) > 0.3
    assert check.diff_gap(grads[0], grads[0], keep) == 0.0
