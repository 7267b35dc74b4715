"""A configuration's training recipe reaches the program and the plain
reference: the paper's Full model (``fashion256`` with the reference
code's full_fasion keys: a VGG19 ``block1_conv2`` nearest-neighbour
content loss in a 5 × 5 area at weight 1) built in memory, no file of it
kept. The reference's content path against the program's, a run of the
recipe, the control and the planted faults, and the configuration keys
that the program and the reference take or refuse. On the CPU at a small
size; the ``cuda`` twins at the recipe's own size on the card."""

import copy
import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import calibrate, measure, run, synthetic
from portbench.cell import Run
from portbench.reference import content
from portbench.reference import model as ref
from portbench.reference import train as ref_train
from portbench.weights import make_weights

FULL = {"content_loss_layer": "block1_conv2", "nn_loss_area_size": 5,
        "l1_penalty_weight": 1.0}
ACCEPTED = ["fashion256-train-b32", "h36m224-train-b32",
            "h36m224-serve-offline-b32"]
SEED = 2**31 + 4099


def _full(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    spec["config"].update(FULL)
    spec["name"] = "fashion256-full-train-b32"
    return spec


def _run(spec, seed, device="cpu") -> Run:
    return Run(cell=spec["name"], config=spec["config"], mix=spec["mix"],
               limits=spec["work"]["limits"], seed=seed, seconds=1.0,
               trace=False, device=torch.device(device),
               t_start=time.perf_counter())


def _vgg(seed, device):
    from pose_transfer_torch.models.vgg import VGG19Features
    w = make_weights(content.vgg_spec(), seed, device)
    vgg = VGG19Features(device=device)
    vgg.load_state_dict(w)
    return w, vgg.eval().requires_grad_(False)


def _images(seed, n, size, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n, size, size, 3), generator=g,
                      device=device) * 2.0 - 1.0


def _features_match(layer, n, size, device):
    from pose_transfer_torch.models.vgg import extract_named
    w, vgg = _vgg(11, device)
    x = _images(12, n, size, device)
    with torch.no_grad():
        want = extract_named(vgg, x, layer)
        got = content.features(w, x, content.layer_index(layer))
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def _nn_loss_matches(pred, target, area) -> None:
    """Value to rtol 1e-6; the gradient equal wherever one shift holds the
    least distance alone, and ties are a small share."""
    from pose_transfer_torch.ops.nn_loss import nn_loss
    p1 = pred.clone().requires_grad_(True)
    p2 = pred.clone().requires_grad_(True)
    want = nn_loss(p1, target, area, area)
    got = content.nn_loss(p2, target, area)
    assert got.item() == pytest.approx(want.item(), rel=1e-6)
    want.backward()
    got.backward()
    pad = area // 2
    g = torch.nn.functional.pad(target, (0, 0, pad, pad, pad, pad),
                                value=content.PAD_VALUE)
    h, w = pred.shape[1:3]
    d = torch.stack([(g[:, i:i + h, j:j + w] - pred).abs().sum(-1)
                     for i in range(area) for j in range(area)])
    unique = (d == d.min(0).values).sum(0) == 1
    assert unique.float().mean() > 0.99
    assert torch.equal(p2.grad[unique], p1.grad[unique])


def _variant_fails(spec, variant, device, seed) -> None:
    numbers = calibrate.train_readings(_run(spec, seed, device),
                                       [variant])[variant]
    limits = spec["work"]["limits"]
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)


# --------------------------------------------------- the reference's parts

@pytest.mark.parametrize("layer", ["block1_conv2", "block2_conv2",
                                   "block3_conv1"])
def test_vgg_prefix_matches_the_program(layer):
    _features_match(layer, 2, 32, "cpu")


def test_layer_index_keeps_the_reference_quirk():
    from pose_transfer_torch.models.vgg import get_layer_ind
    for name in ("block1_conv2", "block2_conv1", "block3_conv4",
                 "block5_conv2"):
        assert content.layer_index(name) == get_layer_ind(name)
    assert content.layout()[content.layer_index("block1_conv2")][0] == "relu"
    with pytest.raises(ValueError):
        content.layer_index("conv1_block2")


@pytest.mark.parametrize("area", [1, 3, 5])
def test_nn_loss_matches_the_program(area):
    g = torch.Generator().manual_seed(area)
    pred = torch.randn((2, 12, 10, 8), generator=g)
    target = torch.randn((2, 12, 10, 8), generator=g)
    _nn_loss_matches(pred, target, area)


def test_nn_loss_ties_on_a_flat_target_match_the_program():
    """Where every shift reads the same target features the gradient that
    the minimums split adds up, to rounding, to the program's first-shift
    one."""
    from pose_transfer_torch.ops.nn_loss import nn_loss
    pred = torch.randn((2, 9, 9, 4), generator=torch.Generator()
                       .manual_seed(1))
    target = torch.full_like(pred, 0.25)
    p1 = pred.clone().requires_grad_(True)
    p2 = pred.clone().requires_grad_(True)
    nn_loss(p1, target, 5, 5).backward()
    content.nn_loss(p2, target, 5).backward()
    torch.testing.assert_close(p2.grad, p1.grad, rtol=1e-6, atol=0)


def test_nn_loss_blocks_add_up():
    g = torch.Generator().manual_seed(3)
    pred = torch.randn((5, 8, 8, 4), generator=g)
    target = torch.randn((5, 8, 8, 4), generator=g)
    grads = []
    values = []
    for rows in (None, 1, 2):
        p = pred.clone().requires_grad_(True)
        loss = content.nn_loss(p, target, 3, block_rows=rows)
        loss.backward()
        values.append(loss.item())
        grads.append(p.grad)
    assert values[1] == pytest.approx(values[0], rel=1e-6)
    assert values[2] == pytest.approx(values[0], rel=1e-6)
    assert torch.equal(grads[1], grads[0]) and torch.equal(grads[2],
                                                           grads[0])


def test_content_step_flops_equal_the_counter():
    size, k, n = (64, 64), 18, 2
    rng = np.random.default_rng(0)
    batches = [ref.prepare(synthetic.compact_batch(rng, n, size, k), size,
                           "cpu") for _ in range(3)]
    gw = make_weights(ref.generator_spec(size, k), 1, "cpu")
    dw = make_weights(ref.discriminator_spec(k), 2, "cpu")
    vw = make_weights(content.vgg_spec(), 3, "cpu")
    recipe = ref_train.Recipe(size, k, content_layer="block1_conv2",
                              nn_area=5)
    with FlopCounterMode(display=False) as fc:
        ref_train.train_step(gw, dw, ref_train.Adam(2e-4),
                             ref_train.Adam(2e-4), *batches, recipe,
                             torch.Generator().manual_seed(0), vgg=vw)
    assert fc.get_total_flops() == measure.train_step_flops(size, k, n) \
        + measure.content_flops(size, "block1_conv2", n)
    assert measure.content_flops(size, "none", n) == 0


# -------------------------------------------------------- runs and checks

def test_recipe_run_is_correct(small):
    res = run.execute(_full(small("fashion256-train-b32")), SEED, 1.0,
                      False, "cpu", time.perf_counter())
    assert res["result"]["correct"], res["checks"]
    assert res["info"]["losses"][0][4] == pytest.approx(
        res["info"]["reference_losses"][0][4], rel=1e-3)


@pytest.mark.parametrize("variant", ["control", "half_batch", "gen_lr10",
                                     "nn_area1"])
def test_control_and_faults_fail_small(variant, small):
    _variant_fails(_full(small("fashion256-train-b32")), variant, "cpu",
                   2**32 + 17)


def _program_area1(monkeypatch):
    """The program's nn_loss at a 1 × 1 neighbourhood."""
    from pose_transfer_torch.train import engine
    real = engine.nn_loss
    monkeypatch.setattr(engine, "nn_loss",
                        lambda p, g, nh, nw: real(p, g, 1, 1))


def _program_l1(monkeypatch):
    """The program's reconstruction loss L1 at the file's weight, as it
    trained when the harness dropped the content keys."""
    from pose_transfer_torch.train import engine, losses
    monkeypatch.setattr(engine, "reconstruction_loss",
                        lambda out, target, vgg, config:
                        losses.l1_loss(out, target))


@pytest.mark.parametrize("fault", [_program_area1, _program_l1])
def test_program_off_the_recipe_is_not_correct(fault, small, monkeypatch):
    fault(monkeypatch)
    res = run.execute(_full(small("fashion256-train-b32")), SEED, 1.0,
                      False, "cpu", time.perf_counter())
    assert not res["result"]["correct"], res["checks"]


def test_faults_follow_the_recipe():
    assert "nn_area1" in calibrate.variants_of({**FULL})
    assert "nn_area1" not in calibrate.variants_of(
        run.cell_spec("fashion256-train-b32")["config"])


# ------------------------------------------------------ configuration keys

def test_program_config_carries_the_recipe():
    spec = _full(run.cell_spec("fashion256-train-b32"))
    spec["config"]["num_stacks"] = 3
    cfg = _run(spec, 1).program_config(32)
    assert (cfg.content_loss_layer, cfg.nn_loss_area_size,
            cfg.l1_penalty_weight, cfg.num_stacks) == \
        ("block1_conv2", 5, 1.0, 3)
    recipe = ref_train.recipe(spec["config"])
    assert (recipe.content_layer, recipe.nn_area, recipe.l1_weight) == \
        ("block1_conv2", 5, 1.0)


@pytest.mark.parametrize("key", ["tv_penalty_weight", "weight_init",
                                 "warp_backend"])
def test_program_config_refuses_an_unknown_key(key):
    spec = run.cell_spec("fashion256-train-b32")
    spec["config"][key] = 1
    with pytest.raises(ValueError, match=key):
        _run(spec, 1).program_config(32)


@pytest.mark.parametrize("key,value", [("gen_type", "stacked"),
                                       ("warp_agg", "avg"),
                                       ("training_ratio", 2),
                                       ("tv_penalty_weight", 0.1)])
def test_reference_refuses_what_it_does_not_compute(key, value):
    config = {**run.cell_spec("fashion256-train-b32")["config"], **FULL,
              key: value}
    with pytest.raises(ValueError, match=key):
        ref_train.recipe(config)


def _parent_program_config(r, batch):
    """``Run.program_config`` as the benchmark's first version built it."""
    from pose_transfer_torch.train.engine import GANConfig
    c = r.config
    return GANConfig(
        image_size=r.image_size, pose_dim=r.pose_dim,
        batch_size=batch, use_input_pose=c["use_input_pose"],
        warp_skip=c["warp_skip"], warp_agg=c["warp_agg"],
        gen_type=c["gen_type"],
        compute_dtype=r.compute_dtype,
        training_ratio=c["training_ratio"],
        learning_rate=c["learning_rate"],
        l1_penalty_weight=c["l1_penalty_weight"],
        gan_penalty_weight=c["gan_penalty_weight"],
        check_mode=False)


@pytest.mark.parametrize("cell", ACCEPTED)
def test_accepted_configs_and_seeds_unchanged(cell):
    spec = run.cell_spec(cell)
    for seed in (0, 1, 2**31 + 11, 2**33 + 5):
        r = _run(spec, seed)
        assert dataclasses.asdict(r.program_config(32)) == \
            dataclasses.asdict(_parent_program_config(r, 32))
        kids = np.random.SeedSequence(seed).spawn(4)
        parent = {n: int(k.generate_state(1, np.uint64)[0] >> 1)
                  for n, k in zip(("gen_weights", "disc_weights",
                                   "dropout", "traffic"), kids)}
        seeds = r.seeds()
        assert {k: seeds[k] for k in parent} == parent
        assert seeds["vgg_weights"] not in parent.values()
    ref_train.recipe(spec["config"])


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_content_parts_match_the_program_at_size(cuda_device):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _features_match("block1_conv2", 32, 256, cuda_device)
    w, vgg = _vgg(21, cuda_device)
    from pose_transfer_torch.models.vgg import extract_named
    with torch.no_grad():
        pred = extract_named(vgg, _images(22, 32, 256, cuda_device),
                             "block1_conv2")
        target = extract_named(vgg, _images(23, 32, 256, cuda_device),
                               "block1_conv2")
    _nn_loss_matches(pred, target, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["control", "half_batch", "gen_lr10",
                                     "nn_area1"])
def test_control_and_faults_fail_at_size(variant, cuda_device):
    _variant_fails(_full(run.cell_spec("fashion256-train-b32")), variant,
                   cuda_device, 2**32 + 18)
