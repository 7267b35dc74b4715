"""``fold_place_roofline.serve``: the place kernel of the fold
(``ops/warp_fused.py::fold_place`` → ``csrc/fold_place.cu``) against its
roofline over the traced window: the least time of every launch, from the
shapes the benchmark recorded at each call, over the launches' device
time in the trace. None when the trace holds no such launch."""

from portbench.measure import fold_roofline


def read(out, run):
    return fold_roofline(out.window.trace, out.readings.get("launch_records"),
                         "fold_place")
