"""``serve.fit_ms``: the mean duration of the ``serve.fit`` spans that
ended in the traced window: a request's host-side preparation on the
client's thread (``PoseTransferServer.prepare_request``: ``warp_fit``
and the checks), ms."""

from portbench import spans


def read(out, run):
    recs = spans.window_records(out, run)
    return None if recs is None else spans.mean_ms(
        out.window.trace, recs, "serve.fit", per="serve.batch")
