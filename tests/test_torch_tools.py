"""The arithmetic of ``pose_transfer_torch.tools.profile_serve`` on the CPU:
the device idle share from a trace's intervals, and the open-loop load
generator against a narrow CPU server."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pose_transfer_torch.data.synthetic import random_image, random_skeleton
from pose_transfer_torch.models.networks import (DeformableGenerator,
                                                 init_weights)
from pose_transfer_torch.serve import PoseTransferServer
from pose_transfer_torch.tools.profile_serve import _idle_share, _serve_load
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
