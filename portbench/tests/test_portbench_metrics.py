"""The yardstick's arithmetic: idle time at the window's head and tail,
failures beyond the percentile, rooflines that cannot pass 100 % for
launches they bound themselves, and the FLOP count against PyTorch's
counter on the reference."""

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import breakdown, measure, synthetic
from portbench.reference import model as ref
from portbench.reference import train as ref_train
from portbench.trace import Trace
from portbench.weights import make_weights


def test_idle_counts_head_and_tail():
    # busy 20..40 and 50..80 of a 0..100 window: the head and tail idle too
    ivs = [(20, 40), (30, 35), (50, 80)]
    assert measure.busy_seconds(ivs, 0, 100) == 50
    assert measure.idle_share(ivs, 0, 100) == pytest.approx(50.0)
    assert measure.idle_gaps(ivs, 0, 100) == [(0, 20), (40, 50), (80, 100)]
    # intervals that cross the window's ends are clipped to it
    assert measure.busy_seconds([(-10, 10), (90, 120)], 0, 100) == 20


def test_failed_request_lands_beyond_p95():
    lat = np.linspace(0.01, 0.1, 100)
    base = measure.percentile_ms(lat, 95)
    # the fastest request failing instead moves the 95th percentile up
    failed = lat.copy()
    failed[0] = math.inf
    assert measure.percentile_ms(failed, 95) > base
    # five failures of a hundred sit beyond it, a sixth reaches it
    failed[:5] = math.inf
    assert math.isfinite(measure.percentile_ms(failed, 95))
    failed[:6] = math.inf
    assert measure.percentile_ms(failed, 95) == math.inf


def _trace(kernels, start=0, end=10**9):
    return Trace(start, end, kernels, [])


@pytest.mark.parametrize("slowdown", [1.0, 1.3, 4.0])
def test_roofline_never_passes_100(slowdown):
    recs = [("fold_place", 8, 256, 256, 64, 9, 128, 144, 2, False),
            ("fold_place", 8, 128, 128, 128, 9, 64, 80, 2, True),
            ("fold_route", 8, 224, 224, 64, 4, 112, 128, 2, True)]
    kernels, t = [], 1000
    for r in recs:
        _, n, h, w, c, p, sy, sx, size, idx = r
        nbytes = measure.place_bytes(n, h, w, c, p, sy, sx, size, idx) \
            if r[0] == "fold_place" else \
            measure.route_bytes(n, h, w, c, p, sy, sx, size)
        dur = measure.least_seconds(nbytes, measure.fold_ops(n, p, sy, sx,
                                                             c))
        ns = int(math.ceil(dur * 1e9 * slowdown))
        name = f"void (anonymous namespace)::{r[0]}_kernel<bf16>"
        kernels.append((name, t, t + ns))
        t += ns + 10
    tr = _trace(kernels)
    for k in ("fold_place", "fold_route"):
        share = measure.fold_roofline(tr, recs, k)
        assert 0 < share <= 100.0
        assert share == pytest.approx(100.0 / slowdown, rel=1e-3)


def test_roofline_silent_without_its_launches():
    tr = _trace([("fold_place_kernel", 0, 100)])
    one = ("fold_place", 1, 64, 64, 8, 1, 32, 48, 2, False)
    assert measure.fold_roofline(tr, [], "fold_place") is None
    assert measure.fold_roofline(None, [one], "fold_place") is None
    assert measure.fold_roofline(_trace([]), [one], "fold_place") is None
    # counts that differ: only a shape all records share names the launch
    other = ("fold_place", 2, 64, 64, 8, 1, 32, 48, 2, False)
    assert measure.fold_roofline(tr, [one, other], "fold_place") is None
    shared = measure.fold_roofline(tr, [one] * 3, "fold_place")
    assert shared == measure.fold_roofline(tr, [one], "fold_place")


def test_flop_count_equals_the_counter_on_the_reference():
    size, k, n = (64, 64), 18, 2
    rng = np.random.default_rng(0)
    batches = [ref.prepare(synthetic.compact_batch(rng, n, size, k), size,
                           "cpu") for _ in range(3)]
    gw = make_weights(ref.generator_spec(size, k), 1, "cpu")
    dw = make_weights(ref.discriminator_spec(k), 2, "cpu")
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            ref.generator(gw, batches[0], size, k)
    assert fc.get_total_flops() == n * measure.gen_forward_flops(size, k)
    with FlopCounterMode(display=False) as fc:
        ref_train.train_step(gw, dw, ref_train.Adam(2e-4),
                             ref_train.Adam(2e-4), *batches,
                             ref_train.Recipe(size, k),
                             torch.Generator().manual_seed(0))
    assert fc.get_total_flops() == measure.train_step_flops(size, k, n)


def test_full_size_counts():
    # FlopCounterMode over the port's 'exact' path at full size counts
    # 138.5 / 104.9 GFLOP a forward and 582.4 / 441.0 a step's batch row,
    # its mask resizes' matmuls included
    assert measure.gen_forward_flops((256, 256), 18) / 1e9 == \
        pytest.approx(138.5, rel=5e-3)
    assert measure.gen_forward_flops((224, 224), 16) / 1e9 == \
        pytest.approx(104.9, rel=5e-3)
    assert measure.train_step_flops((256, 256), 18, 1) / 1e9 == \
        pytest.approx(582.4, rel=5e-3)
    assert measure.train_step_flops((224, 224), 16, 1) / 1e9 == \
        pytest.approx(441.0, rel=5e-3)


def test_breakdown_names_gaps_by_host_range():
    tr = Trace(0, 100, [("conv_fprop", 10, 40), ("fold_place_kernel",
                                                  60, 70)],
               [("bench.window", 1, 0, 100), ("bench.client.idle", 1, 0, 9),
                ("aten::item", 2, 40, 59)])
    gaps = breakdown.idle_gaps(tr)
    assert gaps[0] == ["none", 30e-9]
    assert ["aten::item", 20e-9] in gaps
    assert ["bench.client.idle", 10e-9] in gaps
    ops = dict(breakdown.device_ops(tr))
    assert ops["conv: conv_fprop"] == 30e-9
