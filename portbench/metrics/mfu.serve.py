"""``mfu.serve``: model FLOPs of the generator forwards of the images
served in the window (``portbench.measure.gen_forward_flops`` each) over
the window's seconds, as a share of the card's bf16 dense peak."""

from portbench.measure import gen_forward_flops, mfu


def read(out, run):
    images = out.readings.get("images")
    if not images:
        return None
    return mfu(images * gen_forward_flops(run.image_size, run.pose_dim),
               out.window.seconds)
