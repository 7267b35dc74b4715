"""What the program's own spans say about a traced window.

The program (``pose_transfer_torch/utils/spans.py``) records its spans
while a profiler records, on the profiler's clock (``time.time_ns()``,
Unix ns, as the trace's intervals are). The readers of the span metrics
take the records whose end lies inside the traced window and lay them over
the device's idle gaps (``measure.idle_gaps``, the window's head and tail
included).

A reader returns None only when the run has no trace, or when the program
has no span recorder (an older program). It raises when the trace holds
device work but the program recorded none of the spans the metric counts
by (``serve.batch``, ``train.gen_phase``): a broken gate must not read as
a missing number.
"""

from __future__ import annotations

import bisect
import importlib
import statistics

from . import measure

RECORDER = "pose_transfer_torch.utils.spans"


def window_records(out, run) -> list | None:
    """The program's records that ended inside the traced window, or None
    without a trace or a recorder. Notes in ``run.notes['spans']`` how
    many the program holds and how many it dropped."""
    trace = out.window.trace
    if trace is None:
        return None
    try:
        spans = importlib.import_module(RECORDER)
    except ModuleNotFoundError as e:
        if e.name != RECORDER:
            raise
        return None
    held = spans.records()
    recs = [r for r in held if trace.start <= r.end_ns <= trace.end]
    run.notes.setdefault("spans", {}).update(
        {"held": len(held), "in_window": len(recs),
         "dropped": spans.dropped()})
    return recs


def named(trace, recs, name: str, required: bool = False) -> list:
    """The records called ``name``; with ``required``, raise where there
    is none though the trace holds device work."""
    out = [r for r in recs if r.name == name]
    if required and not out and trace.device:
        raise RuntimeError(f"the trace holds device work but the program "
                           f"recorded no {name} span in the window")
    return out


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_within(trace, intervals) -> int:
    """ns of device idle (the window's gaps) inside the union of the host
    ``intervals``."""
    gaps = measure.idle_gaps(trace.intervals(), trace.start, trace.end)
    total, i = 0, 0
    for s, e in _union(intervals):
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            total += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
    return total


def idle_ms_per(trace, recs, names, per: str) -> float:
    """Device idle inside the spans called one of ``names``, ms per span
    called ``per``."""
    count = len(named(trace, recs, per, required=True))
    spans = [(r.start_ns, r.end_ns) for r in recs if r.name in names]
    return idle_within(trace, spans) / 1e6 / count


def _gap_of(gaps, starts, t):
    """The index of the gap that contains ``t``, or None."""
    k = bisect.bisect_right(starts, t) - 1
    return k if k >= 0 and t <= gaps[k][1] else None


def gaps_holding(trace, times) -> list:
    """The idle gaps of the window that contain one of ``times``, each
    once."""
    gaps = measure.idle_gaps(trace.intervals(), trace.start, trace.end)
    starts = [s for s, _ in gaps]
    held = {_gap_of(gaps, starts, t) for t in times} - {None}
    return [gaps[k] for k in sorted(held)]


def share_ending_in_gap(trace, recs, name: str) -> float | None:
    """% of the spans called ``name`` that end while the device is idle;
    None without such spans. A span around a host sync ends after the
    device drained and before the next launch, so this reads 100 where
    the records and the trace share a clock."""
    gaps = measure.idle_gaps(trace.intervals(), trace.start, trace.end)
    starts = [s for s, _ in gaps]
    ends = [r.end_ns for r in named(trace, recs, name)]
    if not ends:
        return None
    inside = sum(_gap_of(gaps, starts, t) is not None for t in ends)
    return 100.0 * inside / len(ends)


def sync_idle_ms_per(trace, recs, name: str, per: str) -> float:
    """Device idle in the gaps that contain the end of a span called
    ``name``, ms per span called ``per``: the device drained while the
    host waited, until the host launched again."""
    count = len(named(trace, recs, per, required=True))
    ends = [r.end_ns for r in named(trace, recs, name)]
    return sum(e - s for s, e in gaps_holding(trace, ends)) / 1e6 / count


def share_holding_gap_start(trace, recs, name: str) -> float | None:
    """% of the spans called ``name`` inside which a device idle gap
    starts (the window's head left out); None without such spans."""
    gaps = measure.idle_gaps(trace.intervals(), trace.start, trace.end)
    starts = [s for s, _ in gaps if s > trace.start]
    spans = named(trace, recs, name)
    if not spans:
        return None
    hit = 0
    for r in spans:
        k = bisect.bisect_left(starts, r.start_ns)
        hit += k < len(starts) and starts[k] <= r.end_ns
    return 100.0 * hit / len(spans)


def clock_offsets_us(trace, recs, name: str) -> dict | None:
    """Each record called ``name`` against the profiler's own range of
    the same span (the trace's host range of that name nearest in
    start): the median and the largest start offset (record − range),
    µs, over the window and over its first and last tenths. None where
    the profiler saw no such range (a thread it does not see)."""
    ranges = sorted(s for n, _, s, _ in trace.host if n == name)
    spans = sorted(r.start_ns for r in named(trace, recs, name))
    if not ranges or not spans:
        return None
    offs = []
    for t in spans:
        k = bisect.bisect_left(ranges, t)
        near = min(ranges[max(k - 1, 0):k + 1], key=lambda s: abs(t - s))
        offs.append((t, (t - near) / 1e3))
    tenth = (trace.end - trace.start) / 10

    def stats(part):
        vals = [o for _, o in part]
        return {"n": len(vals), "median": statistics.median(vals),
                "max_abs": max(abs(v) for v in vals)} if vals else None

    return {"all": stats(offs),
            "first_tenth": stats([x for x in offs
                                  if x[0] < trace.start + tenth]),
            "last_tenth": stats([x for x in offs
                                 if x[0] > trace.end - tenth])}


def median_sample(trace, recs, name: str, per: str) -> float:
    """The median value of the samples called ``name``."""
    named(trace, recs, per, required=True)
    values = [r.attrs["value"] for r in named(trace, recs, name)]
    if not values:
        raise RuntimeError(f"no {name} sample beside the {per} spans")
    return statistics.median(values)


def mean_ms(trace, recs, name: str, per: str) -> float:
    """The mean duration of the spans called ``name``, ms."""
    named(trace, recs, per, required=True)
    spans = named(trace, recs, name)
    if not spans:
        raise RuntimeError(f"no {name} span beside the {per} spans")
    return sum(r.end_ns - r.start_ns for r in spans) / 1e6 / len(spans)


def fallback_share(trace, recs, per: str) -> float:
    """% of the windowable fold instances (``fold.fwd.*`` spans of branch
    'place', 'xla' or 'fallback') that fell back to the full scan; 0 where
    none was windowable."""
    named(trace, recs, per, required=True)
    branches = [r.attrs["branch"] for r in recs
                if r.name.startswith("fold.fwd.")]
    windowable = sum(b in ("place", "xla", "fallback") for b in branches)
    fell = branches.count("fallback")
    return 100.0 * fell / windowable if windowable else 0.0
