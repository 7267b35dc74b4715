"""``train.plan_sync_idle_ms``: device idle in the gaps that contain the
end of a ``fold.plan_sync`` span (``ops/warp.py::plan_folds``' one host
sync a forward: the device drains while the host waits), ms per
``train.gen_phase`` span (one a step) of the traced window. Notes in
``run.notes['spans']`` the share of those spans inside which an idle gap
starts, the share that end while the device is idle, and each record's
start against the profiler's own range of the same span (the checks that
the records and the trace share a clock)."""

from portbench import spans


def read(out, run):
    recs = spans.window_records(out, run)
    if recs is None:
        return None
    trace = out.window.trace
    run.notes["spans"].update(
        plan_sync_holding_gap_start_pct=spans.share_holding_gap_start(
            trace, recs, "fold.plan_sync"),
        plan_sync_ending_in_gap_pct=spans.share_ending_in_gap(
            trace, recs, "fold.plan_sync"),
        plan_sync_clock_offset_us=spans.clock_offsets_us(
            trace, recs, "fold.plan_sync"))
    return spans.sync_idle_ms_per(trace, recs, "fold.plan_sync",
                                  per="train.gen_phase")
