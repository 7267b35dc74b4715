"""``mfu.train``: model FLOPs of the steps completed in the window (the
convolutions of the two phases, counted from the configuration's shapes
by ``portbench.measure.train_step_flops``) over the window's seconds, as
a share of the card's bf16 dense peak."""

from portbench.measure import mfu


def read(out, run):
    flops = out.readings.get("flops")
    return mfu(flops, out.window.seconds) if flops else None
