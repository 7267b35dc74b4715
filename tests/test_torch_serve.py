"""The port's PoseTransferServer on the CPU against the JAX package's server
on the same requests, plus its own batching contract: padding of partial
batches, ``close()`` failing queued futures, request validation, uint8
output, and entry points that default to CUDA."""

import dataclasses
import functools
import threading

import jax
import numpy as np
import pytest
import torch

from pose_transfer_tpu.data import synthetic as jsyn
from pose_transfer_tpu.models import DeformableGenerator as JGen
from pose_transfer_tpu.serve import PoseTransferServer as JServer
from pose_transfer_tpu.train import GANConfig as JConfig
from pose_transfer_torch.data.dataset import collate
from pose_transfer_torch.models.import_flax import (
    generator_state_dict_from_flax)
from pose_transfer_torch.models.networks import (DeformableGenerator,
                                                 init_weights)
from pose_transfer_torch.serve import PoseTransferServer
from pose_transfer_torch.train.engine import (GANConfig, build_models,
                                              make_eval_step)

torch.set_num_threads(2)

SIZE = (64, 64)
ENC = (8, 16, 16, 16)
DEC = (16, 16, 16, 3)
CFG = GANConfig(image_size=SIZE, pose_dim=18, batch_size=2)


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(jsyn.random_image(rng, SIZE),
             jsyn.random_skeleton(rng, SIZE, 18).astype(np.float32),
             jsyn.random_skeleton(rng, SIZE, 18).astype(np.float32))
            for _ in range(n)]


def _gen(seed=0, **kw):
    """A narrow generator, Glorot-initialised from ``seed``."""
    gen = DeformableGenerator(18, SIZE, ENC, DEC, **kw)
    init_weights(gen, torch.Generator().manual_seed(seed))
    return gen.eval()


def _jax_model(use_input_pose):
    jgen = JGen(pose_dim=18, image_size=SIZE, nfilters_enc=ENC,
                nfilters_dec=DEC, use_input_pose=use_input_pose)
    t = 10
    nc = 3 + 2 * 18 if use_input_pose else 3 + 18
    inp = np.zeros((1, *SIZE, nc), np.float32)
    warps = np.tile(np.eye(3).reshape(-1)[:8].astype(np.float32), (1, t, 1))
    masks = np.ones((1, t, *SIZE), np.float32)
    params = jax.jit(functools.partial(jgen.init, train=False))(
        {"params": jax.random.PRNGKey(1)}, inp, warps, masks)
    return jgen, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("use_input_pose", [True, False])
def test_server_matches_jax_server(use_input_pose):
    """Same weights, same requests (an odd count: one padded batch).
    Without the input pose the packed input is [image ‖ target pose] and
    the pose encoder reads from channel 6 — the reference's quirk."""
    jgen, params = _jax_model(use_input_pose)
    reqs = _requests(3)
    with JServer(JConfig(image_size=SIZE, pose_dim=18, batch_size=2,
                         use_input_pose=use_input_pose), jgen,
                 params, max_wait_ms=20.0) as srv:
        ref = srv.generate(reqs)
    cfg = GANConfig(image_size=SIZE, pose_dim=18, batch_size=2,
                    use_input_pose=use_input_pose)
    gen = _gen(use_input_pose=use_input_pose)
    gen.load_state_dict(generator_state_dict_from_flax(params))
    with PoseTransferServer(cfg, gen, max_wait_ms=20.0, device="cpu") as srv:
        got = srv.generate(reqs)
        stats = srv.stats()
    assert got.shape == (3, *SIZE, 3) and got.dtype == np.float32
    # f32, both on the full-scan fold (the CPU auto rule on both sides);
    # convolution sums associate differently in XLA and oneDNN
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert stats["served"] == 3 and stats["batches"] >= 2
    assert stats["latency_p95_ms"] > 0


def test_server_pads_partial_batches():
    """Outputs equal the direct eval step on batches padded by repeating
    the last request."""
    gen = _gen()
    reqs = _requests(3, seed=1)
    with PoseTransferServer(CFG, gen, max_wait_ms=20.0, device="cpu") as srv:
        outs = srv.generate(reqs)
        samples = [srv.prepare_request(*r) for r in reqs]
    step = make_eval_step(CFG, gen, device="cpu")
    d01, _ = step(collate(samples[:2]))
    d2, _ = step(collate([samples[2], samples[2]]))
    direct = torch.cat([d01, d2[:1]]).numpy()
    np.testing.assert_allclose(outs, direct, atol=1e-6, rtol=0)


def test_close_fails_queued_futures():
    """Requests still queued when the server closes fail; the one already
    running completes; submit after close raises."""
    gen = _gen()
    srv = PoseTransferServer(GANConfig(image_size=SIZE, batch_size=1), gen,
                             device="cpu")
    started, release = threading.Event(), threading.Event()
    real_eval = srv._eval

    def slow_eval(batch):
        started.set()
        release.wait(timeout=30)
        return real_eval(batch)

    srv._eval = slow_eval
    futs = [srv.submit(*r) for r in _requests(3, seed=2)]
    assert started.wait(timeout=30)
    timer = threading.Timer(0.2, release.set)
    timer.start()
    srv.close()
    timer.join(timeout=5)
    assert not srv._thread.is_alive()
    assert futs[0].result(timeout=30).shape == (*SIZE, 3)
    for f in futs[1:]:
        with pytest.raises(RuntimeError, match="server closed"):
            f.result(timeout=30)
    with pytest.raises(RuntimeError):
        srv.submit(*_requests(1)[0])


def test_server_rejects_bad_requests():
    with PoseTransferServer(CFG, _gen(), device="cpu") as srv:
        with pytest.raises(ValueError):
            srv.prepare_request(np.zeros((32, 32, 3), np.uint8),
                                np.zeros((18, 2)), np.zeros((18, 2)))
        with pytest.raises(ValueError):   # wrong K would poison the batch
            srv.prepare_request(np.zeros((*SIZE, 3), np.uint8),
                                np.zeros((19, 2)), np.zeros((18, 2)))
    with pytest.raises(ValueError):
        PoseTransferServer(CFG, _gen(), output_dtype="float16", device="cpu")


def test_server_uint8_output_matches_float():
    gen = _gen()
    reqs = _requests(2, seed=5)
    with PoseTransferServer(CFG, gen, device="cpu") as srv:
        ref = srv.generate(reqs)
    with PoseTransferServer(CFG, gen, output_dtype="uint8",
                            device="cpu") as srv:
        u8 = srv.generate(reqs)
    assert u8.dtype == np.uint8
    exp = ((np.clip(ref, -1, 1) + 1) * 127.5).astype(np.uint8)
    np.testing.assert_array_equal(u8, exp)


def test_build_models_seeded_and_auto_rule():
    """build_models at the config's own filter ladder (full width at 64²:
    encoder 64-128-256-512-512-512)."""
    w = "encoder_app.net.1.net.1.weight"
    a = build_models(CFG, seed=0, device="cpu")
    b = build_models(CFG, seed=0, device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    del b
    c = build_models(CFG, seed=1, device="cpu")
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    del c
    # Glorot-uniform bound sqrt(6 / (fan_in + fan_out)), k4: 16·(64 + 128)
    assert a.state_dict()[w].abs().max() <= (6 / (16 * 192)) ** 0.5
    # the windowed fold is on by default only where the kernel runs
    assert not a.folds.windowed
    del a
    assert build_models(dataclasses.replace(CFG, warp_windowed=True),
                        device="cpu").folds.windowed


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_models(CFG)
    gen = _gen()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(CFG, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseTransferServer(CFG, gen)
