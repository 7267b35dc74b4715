"""The JAX package's checkpoints in the port: a run saved by
``pose_transfer_tpu.train.checkpoint.save`` resumed, loaded and
warm-started from; the inverse weight map against JAX's ``import_torch``;
the port's files taking precedence over JAX's; a JAX run's ``models/``
directory scored and trained on by the port's CLIs.

A check-mode model at 64² (pose_dim 18, batch 2, f32), on the CPU.
Tolerances:
- weights, Adam moments, the step and the mapped trees: bit for bit;
- the generator from the same weights: 1e-4 (convolutions and einsums are
  associated differently by XLA and oneDNN, tests/test_torch_model.py);
- one more training step from the resumed state, dropout off on both
  sides: the losses within 1e-5 relative (``tests/test_torch_train.py``);
  the parameters within 1e-6 relative plus lr/4 absolute. An Adam update
  is about lr (2e-4) in size whatever the gradient's, so where the two
  backward passes differ at their 1e-5 level on a near-zero gradient, its
  update moves by a share of lr (measured 1.3e-5 at most).
"""

import contextlib
import dataclasses
import io
import json
import os
import types

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from pose_transfer_tpu.data import synthetic as jsyn
from pose_transfer_tpu.models.import_torch import (import_discriminator,
                                                   import_generator)
from pose_transfer_tpu.train import checkpoint as jcheckpoint
from pose_transfer_tpu.train import engine as jengine
from pose_transfer_torch.cli import evaluate as cli_evaluate
from pose_transfer_torch.cli import main as cli_main
from pose_transfer_torch.cli import make_synthetic_data
from pose_transfer_torch.models import import_flax, networks
from pose_transfer_torch.train import checkpoint, engine
from pose_transfer_torch.utils import flax_msgpack

torch.set_num_threads(2)

SIZE = (64, 64)
N = 2
F32_ATOL, LOSS_RTOL = 1e-4, 1e-5
LR = 2e-4


def _cfgs(**kw):
    return (jengine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                              check_mode=True, **kw),
            engine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                             check_mode=True, **kw))


def _batches(seed):
    rng = np.random.default_rng(seed)
    fake, real, gen_b = (jsyn.synthetic_compact_batch(rng, N, SIZE, 18)
                         for _ in range(3))
    stack = lambda b: {k: v[None] for k, v in b.items()}   # noqa: E731
    return stack(fake), stack(real), gen_b


@contextlib.contextmanager
def _dropout_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(networks.ChannelDropout, "forward", lambda self, x: x)
        yield


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _tree_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX check-mode state after one step, saved by JAX at epoch 1, and
    its next step on another batch (dropout off)."""
    root = tmp_path_factory.mktemp("jaxrun")
    jcfg, _ = _cfgs()
    with _dropout_off():
        state, gen, disc = jengine.create_state(jcfg, seed=0)
        step = jengine.make_train_step(jcfg, gen, disc)
        state = step(state, *_batches(0))[0]
        jcheckpoint.save(state, str(root), 1)
        nxt, metrics = step(state, *_batches(1))[:2]
    return {"dir": root, "gen": gen, "state": state, "next": nxt,
            "metrics": {k: np.asarray(v) for k, v in metrics.items()}}


def _resumed(jax_run, seed=5):
    _, tcfg = _cfgs()
    state = engine.create_state(tcfg, seed=seed, device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, epoch = checkpoint.resume(state, str(jax_run["dir"]), seed=3)
    return state, epoch, buf.getvalue()


def test_resume_reads_weights_adam_and_step(jax_run):
    """Weights, both Adam states and the step come across bit for bit (the
    inverse map rebuilds JAX's trees, and the file's bytes but the rng);
    the dropout generator is reseeded from the seed and the step, with a
    note; the generator's output matches JAX's."""
    state, epoch, out = _resumed(jax_run)
    assert epoch == 1 and state.step == 1
    assert "rng key does not carry over" in out and "seed 3 and step 1" in out
    raw = flax_msgpack.load(str(jax_run["dir"] / "gen_001.msgpack"))
    gen_tree, disc_tree = import_flax.train_state_to_flax(state)
    for k in ("params", "opt_state", "step"):
        _tree_equal(gen_tree[k], raw[k])
    draw = flax_msgpack.load(str(jax_run["dir"] / "disc_001.msgpack"))
    _tree_equal(disc_tree, draw)
    gen_tree["rng"] = raw["rng"]
    assert flax_msgpack.serialize(gen_tree) == \
        (jax_run["dir"] / "gen_001.msgpack").read_bytes()
    # torch's Adam state: the step as a float tensor, moments per parameter
    sd = state.gen_opt.state_dict()
    assert len(sd["state"]) == len(list(state.gen.parameters()))
    assert all(float(s["step"]) == 1.0 for s in sd["state"].values())
    seeded = int(np.random.SeedSequence([3, 1]).generate_state(1)[0])
    assert torch.equal(state.rng.get_state(),
                       torch.Generator().manual_seed(seeded).get_state())

    jcfg, tcfg = _cfgs()
    batch = jsyn.synthetic_compact_batch(np.random.default_rng(7), N, SIZE,
                                         18)
    want = np.asarray(jengine.make_eval_step(jcfg, jax_run["gen"])(
        jax_run["state"].gen_params, batch)[0])
    got, _ = engine.make_eval_step(tcfg, state.gen, "cpu")(batch)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_one_more_step_matches_jax(jax_run):
    state, _, _ = _resumed(jax_run)
    _, tcfg = _cfgs()
    with _dropout_off():
        metrics, _ = engine.make_train_step(tcfg, state)(*_batches(1))
    for k in ("gen", "disc"):
        np.testing.assert_allclose(metrics[k].numpy(), jax_run["metrics"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert state.step == 2
    nxt = jax.tree.map(np.asarray, jax_run["next"])
    want = {**import_flax.generator_state_dict_from_flax(nxt.gen_params),
            **{"disc." + k: v for k, v in import_flax
               .discriminator_state_dict_from_flax(nxt.disc_params).items()}}
    got = {**dict(state.gen.named_parameters()),
           **{"disc." + k: v for k, v in state.disc.named_parameters()}}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(),
                                   rtol=1e-6, atol=LR / 4, err_msg=k)


def test_load_params_and_stacked_warm_start_from_msgpack(jax_run, tmp_path):
    """``load_params`` reads a JAX file into a generator or a
    discriminator; the stacked CLI's warm start takes the latest
    ``full_<dataset>/models/gen_*.msgpack`` (a .pt there would come
    first)."""
    _, tcfg = _cfgs()
    want, _, _ = _resumed(jax_run)
    gen = checkpoint.load_params(str(jax_run["dir"] / "gen_001.msgpack"),
                                 engine.build_models(tcfg, 1, "cpu"))
    disc = checkpoint.load_params(
        str(jax_run["dir"] / "disc_001.msgpack"),
        networks.Discriminator(tcfg.input_nc + 3, check_mode=True))
    for a, b in ((gen, want.gen), (disc, want.disc)):
        assert all(torch.equal(x, y) for x, y in
                   zip(a.state_dict().values(), b.state_dict().values()))

    models = tmp_path / "exp" / "full_fasion128128" / "models"
    models.mkdir(parents=True)
    for name in ("gen_001.msgpack", "disc_001.msgpack"):
        (models / name).write_bytes((jax_run["dir"] / name).read_bytes())
    scfg = dataclasses.replace(tcfg, gen_type="stacked", num_stacks=2)
    stacked = engine.create_state(scfg, seed=0, device="cpu")
    opt = types.SimpleNamespace(exp_root=str(tmp_path / "exp"),
                                dataset="fasion128128")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main._warm_start_stacked(opt, stacked)
    assert f"Warm-started stacked generator from {models}/gen_001.msgpack" \
        in buf.getvalue()
    assert all(torch.equal(x, y) for x, y in zip(
        stacked.gen.generator.state_dict().values(),
        want.gen.state_dict().values()))


def test_pt_files_take_precedence_over_msgpack(jax_run, tmp_path):
    """A directory with .pt files resumes from them, even beside a later
    JAX epoch; one with only .msgpack files from those; saves are .pt."""
    for name in ("gen_001.msgpack", "disc_001.msgpack"):
        data = (jax_run["dir"] / name).read_bytes()
        (tmp_path / name.replace("001", "005")).write_bytes(data)
    _, tcfg = _cfgs()
    mine = engine.create_state(tcfg, seed=11, device="cpu")
    mine.step = 4
    with contextlib.redirect_stdout(io.StringIO()):
        fresh, epoch = checkpoint.resume(
            engine.create_state(tcfg, seed=2, device="cpu"), str(tmp_path))
        assert epoch == 5 and fresh.step == 1
        checkpoint.save(mine, str(tmp_path), 2)
        assert sorted(os.listdir(tmp_path)) == [
            "disc_002.pt", "disc_005.msgpack", "gen_002.pt",
            "gen_005.msgpack"]
        back, epoch = checkpoint.resume(
            engine.create_state(tcfg, seed=2, device="cpu"), str(tmp_path))
    assert epoch == 2 and back.step == 4
    assert torch.equal(back.rng.get_state(), mine.rng.get_state())
    assert all(torch.equal(x, y) for x, y in zip(
        back.gen.state_dict().values(), mine.gen.state_dict().values()))
    assert checkpoint.latest(str(tmp_path), "gen").endswith("gen_002.pt")
    assert checkpoint.latest(str(tmp_path / "none"), "gen") is None


def test_msgpack_resume_keeps_the_same_epoch_disc_rule(jax_run, tmp_path):
    (tmp_path / "gen_002.msgpack").write_bytes(
        (jax_run["dir"] / "gen_001.msgpack").read_bytes())
    (tmp_path / "disc_001.msgpack").write_bytes(
        (jax_run["dir"] / "disc_001.msgpack").read_bytes())
    _, tcfg = _cfgs()
    st = engine.create_state(tcfg, seed=2, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(FileNotFoundError, match="matching disc"):
            checkpoint.resume(st, str(tmp_path))
        before = [p.clone() for p in st.disc.parameters()]
        _, epoch = checkpoint.resume(st, str(tmp_path), require_disc=False)
    assert epoch == 2 and st.step == 1
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 st.disc.parameters()))


def _run(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def test_cli_evaluate_and_train_resume_a_jax_run(tmp_path):
    """market (128×64) check mode: the JAX package's ``checkpoint.save``
    writes a run's ``models/``; the port's ``cli.evaluate --resume 1``
    scores its epoch (with ``--warp_backend exact``), ``cli.main --resume
    1`` resumes it at epoch 1 and step 0 and writes .pt files."""
    data = str(tmp_path / "data") + "/"
    _run(make_synthetic_data.main, ["--out", data, "--dataset", "market",
                                    "--pose_dim", "18"])
    exp = tmp_path / "exp"
    jcfg = jengine.GANConfig(image_size=(128, 64), pose_dim=18,
                             batch_size=2, check_mode=True)
    state, _, _ = jengine.create_state(jcfg, seed=4)
    jcheckpoint.save(state, str(exp / "j" / "models"), 1)
    flags = ["--expID", "j", "--data_Dir", data, "--dataset", "market",
             "--pose_dim", "18", "--batch_size", "2", "--checkMode", "1",
             "--exp_root", str(exp), "--device", "cpu", "--resume", "1"]
    out = _run(cli_evaluate.main, flags + ["--max_batches", "1",
                                           "--feat_layer", "none",
                                           "--warp_backend", "exact"])
    res = json.loads(out.strip().splitlines()[-1])
    assert res["epoch"] == 1 and np.isfinite(res["value"])
    out = _run(cli_main.main, flags + [
        "--iters_per_epoch", "2", "--number_of_epochs", "1",
        "--display_ratio", "1", "--checkpoint_ratio", "1"])
    assert "Resume gen from epoch 1" in out and "Resume disc" in out
    assert "rng key does not carry over" in out
    models = exp / "j" / "models"
    assert {"gen_001.pt", "disc_001.pt"} <= set(os.listdir(models))
    saved = torch.load(models / "gen_001.pt", weights_only=True)
    assert saved["step"] == 2                 # 0 from the JAX file, +2
    rows = [json.loads(ln) for ln in
            (exp / "j" / "metrics.jsonl").read_text().splitlines()]
    assert rows and all(np.isfinite(r["gen_total"]) for r in rows)


# ------------------------------------------------------------ inverse map

def _jax_params(gen_type, **kw):
    jcfg, _ = _cfgs(gen_type=gen_type, **kw)
    state, _, _ = jengine.create_state(jcfg, seed=1)
    return jax.tree.map(np.asarray, state.gen_params), \
        jax.tree.map(np.asarray, state.disc_params)


def _perturbed(module, seed):
    """Random weights everywhere, the norms' affines included."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return module


@pytest.mark.parametrize("gen_type", ["baseline", "stacked", "unet"])
def test_generator_inverse_map_matches_jax(gen_type):
    """Port state_dict → flax tree: bit for bit JAX's ``import_torch``
    (deformable and stacked; it has no U-Net), and for every type the exact
    inverse of ``generator_state_dict_from_flax`` on JAX-initialised
    params, keys sorted as JAX sorts them."""
    kw = {"num_stacks": 2} if gen_type == "stacked" else {}
    params, _ = _jax_params(gen_type, **kw)
    sd = import_flax.generator_state_dict_from_flax(params)
    back = import_flax.generator_params_to_flax(sd)
    _tree_equal(back, params)
    assert list(back["params"]) == sorted(back["params"])

    _, tcfg = _cfgs(gen_type=gen_type, **kw)
    gen = _perturbed(engine.build_models(tcfg, 0, "cpu"), 3)
    mine = import_flax.params_to_flax(gen)
    gen.load_state_dict(import_flax.generator_state_dict_from_flax(mine))
    if gen_type != "unet":
        n_enc, n_dec = (len(f) for f in tcfg.filters)
        ref = import_generator(
            {k: v.numpy() for k, v in gen.state_dict().items()}, n_enc,
            n_dec, stacked=gen_type == "stacked")
        _tree_equal(mine, ref)


@pytest.mark.parametrize("check_mode", [False, True])
def test_discriminator_inverse_map_matches_jax(check_mode):
    """Full width: bit for bit JAX's ``import_discriminator``. Check mode
    (3 blocks, which JAX's importer maps as 2): the exact inverse of the
    forward map on JAX-initialised params."""
    disc = _perturbed(networks.Discriminator(3 + 2 * 18 + 3,
                                             check_mode=check_mode), 4)
    mine = import_flax.params_to_flax(disc)
    if check_mode:
        _, params = _jax_params("baseline")
        back = import_flax.discriminator_params_to_flax(
            import_flax.discriminator_state_dict_from_flax(params))
        _tree_equal(back, params)
        assert len(mine["params"]) == 4            # Conv_0, Block_0..2
    else:
        ref = import_discriminator(
            {k: v.numpy() for k, v in disc.state_dict().items()})
        _tree_equal(mine, ref)


def test_adam_state_rejects_other_optimizers(jax_run):
    raw = flax_msgpack.load(str(jax_run["dir"] / "gen_001.msgpack"))
    state, _, _ = _resumed(jax_run)
    bad = {"0": {"count": raw["opt_state"]["0"]["count"],
                 "mu": raw["opt_state"]["0"]["mu"]}, "1": {}}
    with pytest.raises(ValueError, match="optax Adam"):
        import_flax.adam_state_dict_from_flax(bad, state.gen, state.gen_opt)
