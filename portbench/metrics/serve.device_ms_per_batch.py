"""``serve.device_ms_per_batch``: device busy time in the traced window
over the micro-batches the server ran in it."""

from portbench.measure import busy_seconds


def read(out, run):
    tr, batches = out.window.trace, out.readings.get("batches")
    if tr is None or not batches:
        return None
    return 1e3 * busy_seconds(tr.intervals(), tr.start, tr.end) / 1e9 \
        / batches
