"""The arithmetic of ``pose_transfer_torch.tools.profile_serve`` and
``profile_train`` on the CPU: the device idle share from a trace's
intervals, kernel categories, the open-loop load generator against a narrow
CPU server, and the training batches driving a narrow CPU train step; the
fold microbenchmark ``bench_fold`` on the CPU at a tiny shape."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pose_transfer_torch.data.synthetic import random_image, random_skeleton
from pose_transfer_torch.models.networks import (DeformableGenerator,
                                                 Discriminator, init_weights)
from pose_transfer_torch.serve import PoseTransferServer
from pose_transfer_torch.tools import bench_fold
from pose_transfer_torch.tools.profile_serve import (DATASETS, _category,
                                                     _idle_share, _serve_load,
                                                     config_for, requests)
from pose_transfer_torch.tools.profile_train import _batches
from pose_transfer_torch.train import engine, losses
from pose_transfer_torch.train.engine import GANConfig

torch.set_num_threads(2)

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _trace(*events):
    evs = [SimpleNamespace(time_range=SimpleNamespace(start=s, end=e),
                           device_type=d) for s, e, d in events]
    return SimpleNamespace(events=lambda: evs)


def test_idle_share_merges_device_intervals():
    """Overlapping kernels count once, host events not at all; the span
    runs from the first device event to the last."""
    got = _idle_share(_trace((30, 40, CUDA), (0, 10, CUDA), (5, 20, CUDA),
                             (0, 100, CPU)))
    assert got == {"device_span_ms": 0.04, "device_busy_ms": 0.03,
                   "device_idle_share": 0.25}
    with pytest.raises(RuntimeError, match="no device events"):
        _idle_share(_trace((0, 100, CPU)))


@pytest.mark.parametrize("rate", [None, 200.0])
def test_serve_load_counts_every_request(rate):
    size = (64, 64)
    gen = DeformableGenerator(18, size, (8, 16, 16, 16), (16, 16, 16, 3))
    init_weights(gen, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    pool = [(random_image(rng, size),
             random_skeleton(rng, size, 18).astype(np.float32),
             random_skeleton(rng, size, 18).astype(np.float32))
            for _ in range(3)]
    cfg = GANConfig(image_size=size, batch_size=2)
    with PoseTransferServer(cfg, gen.eval(), device="cpu") as srv:
        got = _serve_load(srv, pool, 5, rate, rng)
    assert (got["sent"], got["answered"], got["failed"]) == (5, 5, 0)
    lat = got["latency_ms"]
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    assert got["img_per_s"] > 0 and 0 < got["mean_batch_fill"] <= 2
    assert got["batches"] >= 3


def test_kernel_categories():
    assert _category("void (anonymous namespace)::fold_route_kernel"
                     "<__nv_bfloat16>(...)") == "fold_route"
    assert _category("void (anonymous namespace)::fold_place_kernel"
                     "<float, true>(...)") == "fold_place"
    assert _category("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert _category("void (anonymous namespace)::warp_fold_kernel"
                     "<__nv_bfloat16, false>(...)") == "warp_fold"
    assert _category("void (anonymous namespace)::warp_fold_bwd_kernel"
                     "<float>(...)") == "warp_fold_bwd"
    assert _category("void (anonymous namespace)::fold_place_stream_kernel"
                     "<float, true>(...)") == "fold_place_stream"


def test_profile_train_batches_drive_a_ratio_2_step():
    """Two discriminator draws per step: the disc row is their mean; the
    TV penalty joins the generator's total."""
    size = (64, 64)
    cfg = GANConfig(image_size=size, batch_size=2, training_ratio=2,
                    tv_penalty_weight=0.5, warp_windowed=True)
    fake, real, gen_b = _batches(cfg, np.random.default_rng(0), 1)[0]
    assert fake["image_from"].shape == (2, 2, 64, 64, 3)
    assert gen_b["image_from"].shape == (2, 64, 64, 3)
    gen = DeformableGenerator(18, size, (8, 16, 16, 16), (16, 16, 16, 3),
                              warp_windowed=True)
    disc = Discriminator(cfg.input_nc + 3)
    g = torch.Generator().manual_seed(0)
    init_weights(gen, g)
    init_weights(disc, g)
    state = engine.TrainState(
        gen=gen, disc=disc,
        gen_opt=engine.make_optimizer(cfg, gen.parameters()),
        disc_opt=engine.make_optimizer(cfg, disc.parameters()),
        rng=torch.Generator().manual_seed(1))
    step = engine.make_train_step(cfg, state)
    draws = []
    real_phase = step.disc_phase
    step.disc_phase = lambda *a: draws.append(real_phase(*a)) or draws[-1]
    metrics, out = step(fake, real, gen_b)
    assert len(draws) == 2 and state.step == 1
    assert torch.equal(metrics["disc"], torch.stack(draws).mean(dim=0))
    assert metrics["gen"].shape == (3,) and out.shape == (2, 64, 64, 3)
    total, ll, ad = metrics["gen"].tolist()
    tv = losses.total_variation_loss(out).item()
    assert tv > 0 and total == pytest.approx(ll + ad + 0.5 * tv, rel=1e-6)
    assert all(torch.isfinite(v).all() for v in metrics.values())


@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_profiler_configs_per_dataset(dataset):
    """--dataset: fasion-256 with pose_dim 18 and the 7-stage ladder, h36m
    at 224² with pose_dim 16 and the 6-stage ladder, both bf16 at full
    width (the h36m generator built on the meta device)."""
    cfg = config_for(dataset, 8, "matmul")
    size, pose_dim = DATASETS[dataset]
    assert (cfg.image_size, cfg.pose_dim, cfg.batch_size) == (size, pose_dim,
                                                              8)
    assert cfg.compute_dtype == torch.bfloat16 and cfg.input_nc == \
        3 + 2 * pose_dim
    enc, dec = cfg.filters
    assert len(enc) == (6 if dataset == "h36m" else 7) == len(dec)
    gen = DeformableGenerator(pose_dim, size, enc, dec, device="meta")
    assert gen.encoder_app.net[0].in_channels == 3 + pose_dim
    reqs = requests(np.random.default_rng(0), 2, cfg)
    assert reqs[0][0].shape == (*size, 3)
    assert reqs[0][1].shape == (pose_dim, 2)


def test_serve_load_h36m_requests():
    """The load generator with pose_dim-16 requests against a narrow h36m
    server (the static-empty parts of the fold compacted out)."""
    size = (64, 64)
    gen = DeformableGenerator(16, size, (8, 16, 16, 16), (16, 16, 16, 3))
    init_weights(gen, torch.Generator().manual_seed(0))
    cfg = GANConfig(image_size=size, pose_dim=16, batch_size=2)
    rng = np.random.default_rng(0)
    with PoseTransferServer(cfg, gen.eval(), device="cpu") as srv:
        got = _serve_load(srv, requests(rng, 3, cfg), 4, None, rng)
    assert (got["sent"], got["answered"], got["failed"]) == (4, 4, 0)


def test_profile_train_batches_drive_an_h36m_step():
    """The profiler's pose_dim-16 batches through a narrow train step."""
    size = (64, 64)
    cfg = GANConfig(image_size=size, pose_dim=16, batch_size=2,
                    warp_windowed=True)
    fake, real, gen_b = _batches(cfg, np.random.default_rng(0), 1)[0]
    assert gen_b["kp_from"].shape == (2, 16, 2)
    gen = DeformableGenerator(16, size, (8, 16, 16, 16), (16, 16, 16, 3),
                              warp_windowed=True)
    disc = Discriminator(cfg.input_nc + 3)
    g = torch.Generator().manual_seed(0)
    init_weights(gen, g)
    init_weights(disc, g)
    state = engine.TrainState(
        gen=gen, disc=disc,
        gen_opt=engine.make_optimizer(cfg, gen.parameters()),
        disc_opt=engine.make_optimizer(cfg, disc.parameters()),
        rng=torch.Generator().manual_seed(1))
    metrics, out = engine.make_train_step(cfg, state)(fake, real, gen_b)
    assert out.shape == (2, 64, 64, 3) and state.step == 1
    assert all(torch.isfinite(v).all() for v in metrics.values())


TINY = ["--device", "cpu", "--image_size", "64", "--batch", "2",
        "--iters", "1", "--warmup", "0"]


def _bench_lines(capsys, *args):
    assert bench_fold.main([*TINY, *args]) == 0
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("extra", [[], ["--groups", "9", "--stream_idx"]])
def test_bench_fold_partstream_on_cpu(capsys, extra):
    """Both legs with the JAX tool's keys; on the CPU the per-group window
    warps sum the same ≤ 2 taps per element as the all-parts ones, so the
    legs agree bit for bit (the argmax too)."""
    legs, cmp = (lambda ls: (ls[:2], ls[2]))(
        _bench_lines(capsys, "--experiment", "partstream", *extra))
    groups = 9 if extra else 3
    assert [ln["leg"] for ln in legs] == ["prod_monolithic",
                                          f"partstream_g{groups}"]
    for ln in legs:
        assert {"experiment", "leg", "batch", "shape", "groups", "ms",
                "temp_hbm_gb", "backend", "device"} <= set(ln)
        assert ln["shape"] == [64, 64, 64] and ln["backend"] == "cpu"
        assert ln["temp_hbm_gb"] is None      # device memory: not measured
    assert cmp["bitexact"] and cmp["max_abs_diff"] == 0.0
    assert cmp.get("idx_equal", True) and ("idx_equal" in cmp) == bool(extra)


def test_bench_fold_variant_on_cpu(capsys):
    lines = _bench_lines(capsys, "--variant", "xla,kernel", "--mode", "grad")
    assert [ln["variant"] for ln in lines] == ["xla", "kernel"]
    for ln in lines:
        assert {"variant", "mode", "ms_per_call", "batch", "stage", "shape",
                "dtype", "backend"} <= set(ln)
        assert ln["mode"] == "grad" and ln["ms_per_call"] > 0
    fn = {v: bench_fold.variant_fold(v, "grad", *bench_fold._fold_inputs(
        2, (64, 64), 18, 0, torch.float32, torch.device("cpu")), (64, 64), 18)
        for v in ("xla", "kernel")}
    # same taps, exact sums of at most two products per window element
    assert torch.equal(fn["xla"](), fn["kernel"]())


def test_bench_fold_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda works")
    with pytest.raises(SystemExit, match="CUDA"):
        bench_fold.main(["--experiment", "partstream"])
