"""``content.idle_ms``: device idle inside the content loss's spans
(``content.features``, the VGG19 prefix of both images in
``train/engine.py::reconstruction_loss``; ``content.nn_loss`` and
``content.nn_loss.bwd``, ``ops/nn_loss.py``'s forward and backward), ms
per ``train.gen_phase`` span (one a step) of the traced window: the
content path's host overhead. None without a trace, a span recorder or
such a span."""

from portbench import spans


def read(out, run):
    recs = spans.window_records(out, run)
    if recs is None:
        return None
    names = {r.name for r in recs if r.name.startswith("content.")}
    if not names:
        return None
    return spans.idle_ms_per(out.window.trace, recs, names,
                             per="train.gen_phase")
