"""``norm.device_ms.train``: device ms of the Block norm's kernels
(``ops/norm.py`` → ``csrc/volume_norm.cu``: every kernel whose name holds
``volume_norm``, forward and backward) per ``train.gen_phase`` span (one a
step) of the traced window. None without a trace, a span recorder or such
a launch (a program whose norm runs op by op)."""

from portbench import spans

KERNEL = "volume_norm"


def read(out, run):
    recs = spans.window_records(out, run)
    if recs is None:
        return None
    trace = out.window.trace
    ns = sum(e - s for _, s, e in trace.kernels(KERNEL))
    if not ns:
        return None
    return ns / 1e6 / len(spans.named(trace, recs, "train.gen_phase",
                                      required=True))
