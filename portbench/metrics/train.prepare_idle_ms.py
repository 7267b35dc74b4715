"""``train.prepare_idle_ms``: device idle inside the ``step.prepare``
spans (``TrainStep._prepare``: the batch preparer, three a step), ms per
``train.gen_phase`` span (one a step) of the traced window."""

from portbench import spans


def read(out, run):
    recs = spans.window_records(out, run)
    return None if recs is None else spans.idle_ms_per(
        out.window.trace, recs, {"step.prepare"}, per="train.gen_phase")
