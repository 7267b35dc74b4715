"""``fold.scan_share.train``: the share of the training step's windowable
fold instances (``fold.fwd.*`` spans of branch 'place', 'xla' or
'fallback', ``ops/warp.py::affine_transform_layer``) that fell back to
the full scan in the traced window, %."""

from portbench import spans


def read(out, run):
    recs = spans.window_records(out, run)
    return None if recs is None else spans.fallback_share(
        out.window.trace, recs, per="train.gen_phase")
