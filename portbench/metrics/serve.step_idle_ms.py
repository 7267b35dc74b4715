"""``serve.step_idle_ms``: device idle inside the batcher's ``serve.step``
spans (the eval step's dispatch: preparation, the generator forward), ms
per ``serve.batch`` span of the traced window."""

from portbench import spans


def read(out, run):
    recs = spans.window_records(out, run)
    return None if recs is None else spans.idle_ms_per(
        out.window.trace, recs, {"serve.step"}, per="serve.batch")
