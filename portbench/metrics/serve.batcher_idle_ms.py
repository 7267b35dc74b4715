"""``serve.batcher_idle_ms``: device idle inside the batcher's own work
around the step (``serve.collect``, ``serve.collate``, ``serve.fetch``:
the copy-out, ``serve.deliver``: the futures and their callbacks), ms per
``serve.batch`` span of the traced window."""

from portbench import spans

BATCHER = {"serve.collect", "serve.collate", "serve.fetch", "serve.deliver"}


def read(out, run):
    recs = spans.window_records(out, run)
    return None if recs is None else spans.idle_ms_per(
        out.window.trace, recs, BATCHER, per="serve.batch")
