"""``content.nn_loss_ms``: device ms of the content loss's kernels
(``csrc/nn_loss.cu``, forward and backward) per ``train.gen_phase`` span
(one a step) of the traced window. None without a trace, a span recorder
or such a launch."""

from portbench import content_kernels, spans


def read(out, run):
    recs = spans.window_records(out, run)
    if recs is None:
        return None
    ms = content_kernels.device_ms(out.window.trace)
    if ms is None:
        return None
    return ms / len(spans.named(out.window.trace, recs, "train.gen_phase",
                                required=True))
