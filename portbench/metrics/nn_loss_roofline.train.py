"""``nn_loss_roofline.train``: the content loss's kernels
(``ops/nn_loss.py::nn_loss_fwd``, ``::nn_loss_bwd`` →
``csrc/nn_loss.cu``) against their roofline over the traced window: the
least time of every launch, at the one shape the cell gives them (its
configuration's content layer and its mix's batch), over the launches'
device time in the trace. None when the trace holds no such launch."""

from portbench import content_kernels


def read(out, run):
    return content_kernels.roofline(
        out.window.trace,
        content_kernels.cell_shape(run.config, run.mix["batch"]))
