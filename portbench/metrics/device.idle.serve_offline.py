"""``device.idle.serve_offline``: the share of the traced window in which the
device ran no kernel, copy or set (1 − the union of their intervals over
the window's length), the window's head and tail included."""

from portbench.measure import idle_share


def read(out, run):
    tr = out.window.trace
    return None if tr is None else idle_share(tr.intervals(), tr.start,
                                              tr.end)
