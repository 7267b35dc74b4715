"""The content loss's per-layer metrics (``nn_loss_roofline.train``,
``content.nn_loss_ms``, ``content.idle_ms``) read through their reader
files on a synthetic trace and hand-built span records; None for a
program without the kernels or the spans (the parent's content path, op
by op); and the roofline's bytes and operations at the cell's shape."""

import math
from types import SimpleNamespace

import pytest

from portbench import content_kernels as ck
from portbench import measure
from portbench import run as bench_run
from portbench.trace import Trace
from pose_transfer_torch.utils import spans as program_spans
from pose_transfer_torch.utils.spans import Record

CELL = "fashion256-full-train-b32"
MS = 10**6
FWD = "void (anonymous namespace)::nn_loss_fwd_tile<5>(float const*, ...)"
BWD = "void (anonymous namespace)::nn_loss_bwd_kernel(float const*, ...)"


def _rec(name, start, end, **attrs):
    return Record(0, None, name, 1, int(start * MS), int(end * MS), attrs)


# a 100 ms window of two steps; the device busy 10-30 and 50-70 ms (the
# two nn_loss forwards 1 ms each, the backwards 2 ms each, inside them)
DEVICE = [("k1", 10 * MS, 30 * MS), (FWD, 12 * MS, 13 * MS),
          (BWD, 20 * MS, 22 * MS), ("k2", 50 * MS, 70 * MS),
          (FWD, 52 * MS, 53 * MS), (BWD, 60 * MS, 62 * MS),
          ("elementwise_kernel<128, 2>", 64 * MS, 65 * MS)]
RECS = [
    _rec("train.gen_phase", 1, 40), _rec("train.gen_phase", 41, 99),
    _rec("content.features", 5, 12, area="5x5"),      # idle 5
    _rec("content.nn_loss", 12, 14, area="5x5"),      # idle 0
    _rec("content.nn_loss.bwd", 28, 33, area="5x5"),  # idle 3
    _rec("content.features", 45, 52, area="5x5"),     # idle 5
    _rec("content.nn_loss", 51, 53, area="5x5"),      # overlaps: 0 more
    _rec("content.nn_loss.bwd", 69, 74, area="5x5"),  # idle 4
    _rec("step.prepare", 0, 10),                      # not content
]


def _spec():
    return bench_run.cell_spec(CELL)


def _read(metric, monkeypatch, device=DEVICE, recs=RECS, trace=True):
    monkeypatch.setattr(program_spans, "records", lambda: list(recs))
    spec = _spec()
    out = SimpleNamespace(window=SimpleNamespace(
        trace=Trace(0, 100 * MS, device, []) if trace else None))
    r = SimpleNamespace(notes={}, config=spec["config"], mix=spec["mix"])
    return bench_run.reader(metric)(out, r)


def test_cell_shape_and_counts():
    spec = _spec()
    shape = ck.cell_shape(spec["config"], spec["mix"]["batch"])
    assert shape == (32, 256, 256, 64, 5)
    n, h, w, c, a = shape
    assert ck.nn_loss_bytes(n, h, w, c, "fwd") == 1_075_838_976
    assert ck.nn_loss_bytes(n, h, w, c, "bwd") == 1_075_838_976
    assert ck.nn_loss_bytes(n, h, w, c, "bwd", reached=n * h * w) \
        == 1_612_709_888
    assert ck.nn_loss_ops(n, h, w, c, a, "fwd") == 3 * 25 * 134_217_728
    assert ck.least_seconds(shape, "fwd") * 1e3 == pytest.approx(0.32115,
                                                                 abs=1e-4)
    assert ck.least_seconds(shape, "bwd") * 1e3 == pytest.approx(0.32115,
                                                                 abs=1e-4)
    # bytes bind both directions at this shape
    assert ck.nn_loss_ops(n, h, w, c, a, "fwd") / measure.F32_FLOPS \
        < ck.nn_loss_bytes(n, h, w, c, "fwd") / measure.HBM_BYTES_PER_S
    # no content layer, no shape; a later layer's pools and channels
    assert ck.cell_shape({"content_loss_layer": "none"}, 32) is None
    assert ck.cell_shape({"content_loss_layer": "block3_conv1",
                          "image_size": [256, 256],
                          "nn_loss_area_size": 3}, 4) == (4, 64, 64, 256, 3)


def test_readers_on_a_synthetic_trace(monkeypatch):
    shape = ck.cell_shape(_spec()["config"], 32)
    want_roof = 100.0 * 2 * (ck.least_seconds(shape, "fwd")
                             + ck.least_seconds(shape, "bwd")) / 6e-3
    assert _read("nn_loss_roofline.train", monkeypatch) == \
        pytest.approx(want_roof)
    # 6 ms of nn_loss kernels over two steps
    assert _read("content.nn_loss_ms", monkeypatch) == pytest.approx(3.0)
    # 5 + 3 + 5 + 4 ms idle inside content spans over two steps
    assert _read("content.idle_ms", monkeypatch) == pytest.approx(8.5)


@pytest.mark.parametrize("slowdown", [1.0, 1.7, 5.0])
def test_roofline_never_passes_100(slowdown):
    shape = (32, 256, 256, 64, 5)
    device, t = [], 0
    for name, d in ((FWD, "fwd"), (BWD, "bwd"), (FWD, "fwd")):
        ns = int(math.ceil(ck.least_seconds(shape, d) * 1e9 * slowdown))
        device.append((name, t, t + ns))
        t += ns + 10
    share = ck.roofline(Trace(0, t, device, []), shape)
    assert 0 < share <= 100.0
    assert share == pytest.approx(100.0 / slowdown, rel=1e-4)


@pytest.mark.parametrize("metric", ["nn_loss_roofline.train",
                                    "content.nn_loss_ms", "content.idle_ms"])
def test_readers_silent_without_the_kernels_and_spans(metric, monkeypatch):
    """The parent's content path: no nn_loss kernel in the trace, no
    content span; and no trace at all."""
    plain = [ev for ev in DEVICE if "nn_loss" not in ev[0]]
    no_content = [r for r in RECS if not r.name.startswith("content.")]
    if metric == "content.idle_ms":
        assert _read(metric, monkeypatch, device=plain,
                     recs=no_content) is None
    else:
        assert _read(metric, monkeypatch, device=plain) is None
    assert _read(metric, monkeypatch, trace=False) is None


def test_cell_lists_the_metrics():
    names = {m["name"] for m in _spec()["per_layer"]}
    assert {"nn_loss_roofline.train", "content.nn_loss_ms",
            "content.idle_ms", "train.gen_phase_ms", "mfu.train"} <= names
    for other in ("fashion256-train-b32", "h36m224-train-b32",
                  "h36m224-serve-offline-b32"):
        assert not {"nn_loss_roofline.train", "content.nn_loss_ms",
                    "content.idle_ms"} & {
            m["name"] for m in bench_run.cell_spec(other)["per_layer"]}
