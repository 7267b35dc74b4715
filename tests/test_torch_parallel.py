"""Data-parallel training and serving of the port (``parallel.mesh``) on
the CPU: two gloo ranks against the port's single-process step and
against the JAX package's 2-device mesh step, the replicas of the eval
step and the server, the CLI over two ranks, and the refusals.

The ranks run in one spawn (``parallel.dryrun.train_ranks``) for all
cases: the check-mode model (``dryrun_multichip``'s sizes), a global batch
of 4 (2 rows a rank), f32. Dropout on: 2 steps from the same seed against
the single-process step (every rank draws the global batch's dropout
planes and keeps its rows). Dropout off (every ChannelDropout at p = 0, the
JAX side's ``nn.Dropout`` an identity): one step from JAX's initial weights
against ``pose_transfer_tpu.parallel.make_parallel_train_step`` on a
2-device mesh, for ``dryrun_multichip``'s baseline, windowed
(``warp_place='xla'``) and stacked configurations. In every case the
gradients that each phase's all-reduce hands the optimizer are held
against the single-process step's: the parameters after an Adam step
cannot show a wrong gradient (Adam's first update is ±lr whatever its
size), the gradients do.
"""

import contextlib
import dataclasses
import io
import re
import types

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from pose_transfer_tpu import parallel as jparallel
from pose_transfer_tpu.data import synthetic as jsyn
from pose_transfer_tpu.train import GANConfig as JConfig
from pose_transfer_tpu.train import create_state as jcreate_state
from pose_transfer_torch.cli import main as cli_main
from pose_transfer_torch.cli import make_synthetic_data
from pose_transfer_torch.cli.opts import mesh_from_opt
from pose_transfer_torch.models.import_flax import (
    discriminator_state_dict_from_flax, generator_state_dict_from_flax)
from pose_transfer_torch.models.networks import ChannelDropout
from pose_transfer_torch.parallel import (ProcessGroup, config_for_mesh,
                                          make_parallel_eval_step,
                                          make_parallel_train_step,
                                          shard_batch)
from pose_transfer_torch.parallel.dryrun import (grad_errors, record_grads,
                                                 train_ranks)
from pose_transfer_torch.serve import PoseTransferServer
from pose_transfer_torch.train import checkpoint
from pose_transfer_torch.train.engine import (GANConfig, build_models,
                                              create_state, make_eval_step,
                                              make_train_step)

torch.set_num_threads(2)

WORLD = 2
BASE = dict(pose_dim=18, batch_size=4, check_mode=True, warp_skip="mask",
            training_ratio=1)
# dryrun_multichip's three configurations (__graft_entry__.py:116-125)
JAX_CASES = {
    "baseline": dict(image_size=(64, 64)),
    "windowed": dict(image_size=(64, 64), warp_windowed=True,
                     warp_place="xla"),
    "stacked": dict(image_size=(64, 64), gen_type="stacked", num_stacks=2,
                    warp_windowed=True, warp_place="xla"),
}
DROPOUT_CASE = dict(image_size=(32, 32))
# tests/test_parallel.py:58-76, JAX's own single-device vs mesh tolerances:
# losses; images; parameters after one step, where atol is one Adam update
# quantum (2·lr: a near-zero gradient whose sign flips under the
# all-reduce's f32 reassociation moves its parameter by up to that on a
# step). After a second step the bound adds that step's quantum, 2·lr
# times Adam's largest second step at betas (0.5, 0.999), 1.054·lr
# (chip_smoke.py's DP_PARAM_ATOL)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
OUT_TOL = dict(rtol=2e-3, atol=1e-3)
PARAM_TOL = dict(rtol=2e-3, atol=4.1e-4)
PARAM_TOL_2 = dict(rtol=2e-3, atol=4.1e-4 * 2.054)
# the all-reduced gradients against one process's, per phase (f32; the
# sums differ only in their order): the 2-norm of the difference over the
# net's (GRAD_RTOL) and, per tensor holding at least 1e-3 of the net's
# norm, over the tensor's (GRAD_RTOL_TENSOR)
GRAD_RTOL, GRAD_RTOL_TENSOR = 1e-4, 1e-3


def _batches(cfg, steps, seed=0):
    rng = np.random.default_rng(seed)

    def mk():
        return jsyn.synthetic_compact_batch(
            rng, cfg["batch_size"], cfg["image_size"], cfg["pose_dim"],
            warp_skip=cfg["warp_skip"], gen_type=cfg.get("gen_type",
                                                         "baseline"),
            num_stacks=cfg.get("num_stacks", 4))

    out = []
    for _ in range(steps):
        fake, real = ({k: v[None] for k, v in mk().items()} for _ in "fr")
        out.append((fake, real, mk()))
    return out


def _params_close(got: dict, want: dict, what: str, tol=PARAM_TOL) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   **tol, err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def jax_runs():
    """One step of JAX's 2-device mesh step per case, dropout off: the
    initial weights (as port state_dicts), the stepped ones, the metrics
    and the images."""
    mesh = jparallel.make_mesh(WORLD)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        for name, kw in JAX_CASES.items():
            kw = {**BASE, **kw}
            cfg = jparallel.config_for_mesh(JConfig(**kw), mesh)
            state, gen, disc = jcreate_state(cfg, seed=0)
            host = jax.device_get(state)
            init = {"gen": generator_state_dict_from_flax(host.gen_params),
                    "disc": discriminator_state_dict_from_flax(
                        host.disc_params)}
            batches = _batches(kw, 1)
            step = jparallel.make_parallel_train_step(cfg, gen, disc, mesh)
            s2, m2, out2 = step(jparallel.replicate_state(state, mesh),
                                *batches[0])
            s2 = jax.device_get(s2)
            runs[name] = {
                "kw": kw, "init": init, "batches": batches,
                "params": {"gen": generator_state_dict_from_flax(
                    s2.gen_params), "disc": discriminator_state_dict_from_flax(
                    s2.disc_params)},
                "metrics": {k: np.asarray(v) for k, v in m2.items()},
                "out": np.asarray(out2, np.float32)}
    return runs


@pytest.fixture(scope="module")
def rank_runs(jax_runs):
    """Every case on two gloo ranks in one spawn: results[rank][job]."""
    dropout_kw = {**BASE, **DROPOUT_CASE}
    jobs = [{"config": GANConfig(**dropout_kw),
             "batches": _batches(dropout_kw, 2), "dropout": True,
             "snapshots": True, "grads": True}]
    for run in jax_runs.values():
        jobs.append({"config": GANConfig(**run["kw"]),
                     "batches": run["batches"], "init": run["init"],
                     "dropout": False, "grads": True})
    results = train_ranks(jobs, ["cpu"] * WORLD, threads=2, timeout=300)
    return {"dropout_kw": dropout_kw, "jobs": jobs, "results": results}


def test_ranks_hold_identical_states(rank_runs):
    """After the all-reduced steps both ranks' nets are bitwise equal, and
    every rank reports the same global metrics."""
    r0, r1 = rank_runs["results"]
    for a, b in zip(r0, r1):
        assert a["world"] == b["world"] == WORLD
        assert a["backend"] == "gloo"
        for net in ("gen", "disc"):
            for k in a["params"][net]:
                assert torch.equal(a["params"][net][k], b["params"][net][k])
        assert a["metrics"] == b["metrics"]


def test_two_ranks_match_single_process_with_dropout(rank_runs):
    """2 steps with dropout on, from the same seed: the ranks' nets after
    each step, losses and images against the port's single-process step
    (the same dropout planes; only the all-reduce's f32 reassociation
    differs)."""
    kw = rank_runs["dropout_kw"]
    job = rank_runs["jobs"][0]
    got = rank_runs["results"][0][0]
    cfg = GANConfig(**kw)
    state = create_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, state)
    metrics = []
    for i, batch in enumerate(job["batches"]):
        m, out = step(*batch)
        metrics.append({k: v.tolist() for k, v in m.items()})
        snap, tol = got["snapshots"][i], (PARAM_TOL, PARAM_TOL_2)[i]
        for net in ("gen", "disc"):
            _params_close(snap[net], getattr(state, net).state_dict(),
                          f"{net} after step {i + 1}", tol)
    for mg, mw in zip(got["metrics"], metrics):
        for k in mw:
            np.testing.assert_allclose(mg[k], mw[k], **LOSS_TOL)
    np.testing.assert_allclose(got["out"].numpy(), out.numpy(), **OUT_TOL)


def _single_process_grads(job: dict) -> list:
    """``record_grads`` of the single-process step on ``job`` (as
    ``run_job`` sets it up, without the ranks)."""
    cfg = job["config"]
    state = create_state(cfg, seed=job.get("seed", 0), device="cpu")
    if job.get("init") is not None:
        state.gen.load_state_dict(job["init"]["gen"])
        state.disc.load_state_dict(job["init"]["disc"])
    step = make_train_step(cfg, state)
    if not job["dropout"]:
        for m in state.gen.modules():
            if isinstance(m, ChannelDropout):
                m.p = 0.0
    log = record_grads(step)
    for batch in job["batches"]:
        step(*batch)
    return log


@pytest.mark.parametrize("case", ["dropout", *JAX_CASES])
def test_two_ranks_all_reduce_the_single_process_gradients(rank_runs, case):
    """Every phase's all-reduced gradients (disc, then gen, each step) on
    rank 0 against the single-process step's on the global batch."""
    i = 0 if case == "dropout" else 1 + list(JAX_CASES).index(case)
    job = rank_runs["jobs"][i]
    got = rank_runs["results"][0][i]["grads"]
    assert rank_runs["results"][1][i]["grads"] is None
    want = _single_process_grads(job)
    assert len(got) == len(want) == 2 * len(job["batches"])
    for phase, err in enumerate(grad_errors(got, want)):
        assert err["rel"] <= GRAD_RTOL, (phase, err)
        assert err["worst"] <= GRAD_RTOL_TENSOR, (phase, err)


def test_channel_dropout_shard_keeps_its_rows():
    """Rank r of k draws the global batch's (k·n, C) planes from the
    shared generator and keeps rows r·n..(r+1)·n: the single-device draw's
    rows, and the generator ends in the same state."""
    x = torch.randn(4, 6, 3, 3)
    full = ChannelDropout(0.5).train()
    full.generator = torch.Generator().manual_seed(7)
    want = full(x)
    for rank in range(WORLD):
        drop = ChannelDropout(0.5).train()
        drop.generator = torch.Generator().manual_seed(7)
        drop.shard = (rank, WORLD)
        rows = slice(2 * rank, 2 * rank + 2)
        assert torch.equal(drop(x[rows]), want[rows])
        assert torch.equal(drop.generator.get_state(),
                           full.generator.get_state())


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_two_ranks_match_jax_mesh_step(rank_runs, jax_runs, case):
    """Dropout off, one step from JAX's weights: the port's two ranks
    against JAX's 2-device mesh step: losses, images (the stacked
    generator's every stage, batch on axis 1), both nets."""
    i = 1 + list(JAX_CASES).index(case)
    got, want = rank_runs["results"][0][i], jax_runs[case]
    for k in ("gen", "disc"):
        np.testing.assert_allclose(got["metrics"][0][k], want["metrics"][k],
                                   **LOSS_TOL)
    assert tuple(got["out"].shape) == want["out"].shape
    np.testing.assert_allclose(got["out"].numpy(), want["out"], **OUT_TOL)
    _params_close(got["params"]["gen"], want["params"]["gen"], "gen")
    _params_close(got["params"]["disc"], want["params"]["disc"], "disc")


@pytest.mark.parametrize("gen_type", ["baseline", "stacked"])
def test_parallel_eval_step_matches_single(gen_type):
    """Two CPU replicas, the batch split over them, one thread each: the
    single eval step's images and prepared batch bit for bit."""
    cfg = GANConfig(image_size=(64, 64), pose_dim=18, batch_size=4,
                    check_mode=True, gen_type=gen_type, num_stacks=2)
    gen = build_models(cfg, seed=0, device="cpu")
    batch = _batches(dataclasses.asdict(cfg), 1)[0][2]
    want, prep_want = make_eval_step(cfg, gen, "cpu")(batch)
    step = make_parallel_eval_step(config_for_mesh(cfg, ["cpu"] * WORLD),
                                   gen, ["cpu"] * WORLD)
    got, prep_got = step(batch)
    assert len(step.replicas) == WORLD and step.replicas[0] is gen
    assert torch.equal(got, want)
    for k, v in prep_want.items():
        assert (v is None and prep_got[k] is None) or torch.equal(
            prep_got[k], v), k


def test_batch_that_does_not_divide_raises():
    cfg = GANConfig(image_size=(32, 32), batch_size=3, check_mode=True)
    cfg2 = config_for_mesh(cfg, WORLD)
    gen = build_models(cfg, device="cpu")
    with pytest.raises(ValueError, match="must divide over 2 mesh devices"):
        make_parallel_eval_step(cfg2, gen, ["cpu"] * WORLD)
    with pytest.raises(ValueError, match="must divide over 2 mesh devices"):
        PoseTransferServer(cfg2, gen, devices=["cpu"] * WORLD)
    group = ProcessGroup("gloo", 0, WORLD, torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide over 2 mesh devices"):
        make_parallel_train_step(cfg2, None, group)
    rows = {"x": np.zeros((3, 5))}
    with pytest.raises(ValueError, match="does not divide over 2"):
        shard_batch(rows, 0, WORLD)
    assert shard_batch({"x": np.arange(8).reshape(2, 4)}, 1, WORLD,
                       axis=1)["x"].tolist() == [[2, 3], [6, 7]]


def test_device_count_mismatch_raises_with_jax_message():
    """make_parallel_* validate config.device_count against the width, as
    JAX's ``_check_mesh_config`` does, with its message."""
    cfg = GANConfig(image_size=(32, 32), batch_size=4, check_mode=True)
    gen = build_models(cfg, device="cpu")
    group = ProcessGroup("gloo", 0, WORLD, torch.device("cpu"))
    msg = re.escape("config.device_count=1 but the mesh has 2 device(s). "
                    "Build the models from config_for_mesh")
    with pytest.raises(ValueError, match=msg):
        make_parallel_train_step(cfg, None, group)
    with pytest.raises(ValueError, match=msg):
        make_parallel_eval_step(cfg, gen, ["cpu"] * WORLD)
    assert config_for_mesh(cfg, group).device_count == WORLD
    assert config_for_mesh(cfg, None).device_count == 1
    # the auto windowed rule reads the per-device batch, as JAX's
    from pose_transfer_torch.train.engine import auto_windowed
    cpu = torch.device("cpu")
    big = dataclasses.replace(cfg, batch_size=32)
    assert auto_windowed(big, cpu)
    assert not auto_windowed(config_for_mesh(big, 4), cpu)


def test_mesh_from_opt_rules(monkeypatch, capsys):
    """JAX's ``mesh_from_opt`` rules: 1 is one device; 0 all visible cards,
    with JAX's warning and one device where the batch does not divide; an
    explicit k raises where k devices are missing or the batch does not
    divide; a named device (the CPU, a card) is shared by k."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def opt(device, k):
        return types.SimpleNamespace(device=device, num_devices=k)

    cfg4, cfg3 = (GANConfig(batch_size=b) for b in (4, 3))
    assert mesh_from_opt(opt("cuda", 1), cfg4) is None
    assert mesh_from_opt(opt("cuda", 0), cfg4) == ["cuda:0", "cuda:1"]
    assert mesh_from_opt(opt("cuda", 0), cfg3) is None
    assert "WARNING: batch_size 3 does not divide over the 2 visible " \
        "devices; training single-device" in capsys.readouterr().err
    with pytest.raises(ValueError, match="does not divide over 2 devices"):
        mesh_from_opt(opt("cuda", 2), cfg3)
    with pytest.raises(ValueError, match="--num_devices 4 requested but "
                       "only 2 device"):
        mesh_from_opt(opt("cuda", 4), cfg4)
    assert mesh_from_opt(opt("cpu", 0), cfg4) is None
    assert mesh_from_opt(opt("cpu", 2), cfg4) == ["cpu", "cpu"]
    assert mesh_from_opt(opt("cuda:1", 2), cfg4) == ["cuda:1", "cuda:1"]


def test_server_with_two_replicas_matches_one():
    cfg = GANConfig(image_size=(64, 64), pose_dim=18, batch_size=4,
                    check_mode=True)
    gen = build_models(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(4)
    from pose_transfer_torch.data.synthetic import (random_image,
                                                    random_skeleton)
    reqs = [(random_image(rng, (64, 64)),
             random_skeleton(rng, (64, 64), 18).astype(np.float32),
             random_skeleton(rng, (64, 64), 18).astype(np.float32))
            for _ in range(6)]
    with PoseTransferServer(cfg, gen, device="cpu", max_wait_ms=50) as one:
        want = one.generate(reqs)
    with PoseTransferServer(config_for_mesh(cfg, WORLD), gen,
                            devices=["cpu"] * WORLD, max_wait_ms=50) as two:
        got = two.generate(reqs)
    np.testing.assert_array_equal(got, want)


def _cli(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main.main(argv)
    return buf.getvalue()


def test_cli_two_ranks_resume_single_device(tmp_path):
    """``cli.main --device cpu --num_devices 2``: one epoch of 2 iterations
    on two ranks writes the checkpoints, the grids and metrics.jsonl (rank
    0 alone); the files equal a single-device run's within PARAM_TOL (the
    same global batches and dropout) and resume single-device."""
    data = str(tmp_path / "data") + "/"
    with contextlib.redirect_stdout(io.StringIO()):
        make_synthetic_data.main(["--out", data, "--dataset", "market",
                                  "--pose_dim", "18"])

    def argv(exp, k, epochs=1, resume=0):
        return ["--expID", exp, "--data_Dir", data, "--dataset", "market",
                "--pose_dim", "18", "--batch_size", "2",
                "--iters_per_epoch", "2", "--number_of_epochs", str(epochs),
                "--display_ratio", "1", "--checkpoint_ratio", "1",
                "--checkMode", "1", "--exp_root", str(tmp_path / "exp"),
                "--device", "cpu", "--num_devices", str(k), "--prefetch",
                "0", "--resume", str(resume)]

    out = _cli(argv("dp", 2))
    assert "Data-parallel over 2 ranks: ['cpu', 'cpu']" in out
    exp = tmp_path / "exp" / "dp"
    assert sorted(p.name for p in (exp / "models").iterdir()) == \
        ["disc_001.pt", "gen_001.pt"]
    assert len((exp / "metrics.jsonl").read_text().splitlines()) == 2
    assert len(list((exp / "results" / "train").iterdir())) == 2
    assert len(list((exp / "results" / "test").iterdir())) == 2
    _cli(argv("one", 1))
    models = tmp_path / "exp" / "{}" / "models" / "{}"
    for net in ("gen", "disc"):
        got = torch.load(str(models).format("dp", f"{net}_001.pt"))
        want = torch.load(str(models).format("one", f"{net}_001.pt"))
        params = {k for k in want if k not in checkpoint._EXTRA_KEYS}
        _params_close({k: got[k] for k in params},
                      {k: want[k] for k in params}, net)
    out = _cli(argv("dp", 1, epochs=2, resume=1))
    assert "Resume gen from epoch 1" in out and "Epoch : 2" in out
    assert (exp / "models" / "gen_002.pt").exists()


class _SlowDataset:
    """Items that take a random while to assemble, so that prefetch workers
    finish out of order."""

    def __init__(self, n):
        self.n = n
        self.rng = np.random.default_rng(0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import time
        time.sleep(float(self.rng.uniform(0, 0.004)))
        return {"i": np.array(i)}


def test_rank_streams_take_the_global_batches_in_order():
    """Each rank's prefetching stream (3 workers) hands out its rows of the
    same global batches, in the single-device stream's draw order, the
    seek included: the ranks together see one device's batches."""
    from pose_transfer_torch.data.loader import BatchStream, sample_stream
    ds = _SlowDataset(24)
    single = BatchStream(ds, 4, seed=3, num_threads=1)
    single.seek_batches(2)
    want = [single.next_indices().tolist() for _ in range(12)]
    streams = [sample_stream(ds, 4, seed=3, device="cpu", num_threads=2,
                             num_workers=3, skip_batches=2, rank=r,
                             world=WORLD) for r in range(WORLD)]
    try:
        got = [[next(s)["i"].tolist() for s in streams] for _ in range(12)]
    finally:
        for s in streams:
            s.close()
    assert [a + b for a, b in got] == want
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        BatchStream(ds, 3, rank=0, world=WORLD)
