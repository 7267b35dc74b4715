"""``serve.queue_wait_ms``: the median ``serve.queue_wait`` sample of the
requests the batcher took in the traced window: ms from a request's
enqueue (``PoseTransferServer.submit``) to the batcher taking it
(``pose_transfer_torch/serve.py::_loop``)."""

from portbench import spans


def read(out, run):
    recs = spans.window_records(out, run)
    return None if recs is None else spans.median_sample(
        out.window.trace, recs, "serve.queue_wait", per="serve.batch")
