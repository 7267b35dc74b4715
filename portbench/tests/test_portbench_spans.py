"""The span metrics' arithmetic: a synthetic trace and hand-built records
of the program's recorder with known overlaps, read through each reader
file; None without a trace or a recorder, a raise where the trace holds
device work but the program recorded nothing to count by."""

import sys
from types import SimpleNamespace

import pytest

from portbench import run as bench_run
from portbench import spans
from portbench.trace import Trace
from pose_transfer_torch.utils import spans as program_spans
from pose_transfer_torch.utils.spans import Record

MS = 10**6
# a 100 ms window, the device busy 10-30 and 50-70 ms: idle 0-10, 30-50
# and 70-100
DEVICE = [("k1", 10 * MS, 30 * MS), ("k2", 50 * MS, 70 * MS)]


def _trace(device=DEVICE):
    return Trace(0, 100 * MS, device, [])


def _rec(name, start, end=None, **attrs):
    end = start if end is None else end
    return Record(0, None, name, 1, int(start * MS), int(end * MS), attrs)


SERVE = [
    _rec("serve.batch", 5, 45), _rec("serve.batch", 45, 95),
    _rec("serve.batch", 95, 120),                 # ends past the window
    _rec("serve.step", 8, 12), _rec("serve.step", 48, 55),   # idle 2 + 2
    _rec("serve.collect", 5, 8),                  # idle 3
    _rec("serve.fetch", 25, 35),                  # idle 5
    _rec("serve.deliver", 35, 45),                # idle 10
    _rec("serve.collate", 45, 48),                # idle 3
    _rec("serve.fetch", 65, 80),                  # idle 10
    _rec("serve.queue_wait", 6, value=1.0),
    _rec("serve.queue_wait", 7, value=3.0),
    _rec("serve.queue_wait", 46, value=2.0),
    _rec("serve.queue_wait", 47, value=10.0),
    _rec("serve.queue_wait", 150, value=100.0),   # past the window
    _rec("serve.fit", 1, 3), _rec("serve.fit", 10, 16),
    _rec("fold.fwd.224x224", 9, 9.5, branch="place"),
    _rec("fold.fwd.224x224", 49, 49.5, branch="place"),
    _rec("fold.fwd.112x112", 10, 11, branch="xla"),
    _rec("fold.fwd.112x112", 50, 51, branch="fallback"),
    _rec("fold.fwd.56x56", 11, 11.5, branch="scan"),
]
TRAIN = [
    _rec("train.gen_phase", 1, 40), _rec("train.gen_phase", 41, 99),
    _rec("step.prepare", 0, 12),                  # idle 10
    _rec("step.prepare", 28, 32),                 # idle 2
    _rec("step.prepare", 31, 33),                 # overlaps: idle 1 more
    _rec("fold.plan_sync", 25, 32),    # ends in the 30-50 gap, holds 30
    _rec("fold.plan_sync", 35, 40),    # the same gap: counted once
    _rec("fold.plan_sync", 72, 75),    # ends in the 70-100 gap
    _rec("fold.plan", 20, 41),
    _rec("fold.fwd.256x256", 2, 3, branch="place"),
    _rec("fold.fwd.256x256", 42, 43, branch="fallback"),
    _rec("fold.fwd.128x128", 3, 4, branch="place"),
    _rec("fold.fwd.32x32", 4, 5, branch="scan"),
]

READINGS = [
    ("serve.queue_wait_ms", SERVE, 2.5),           # median of 1, 2, 3, 10
    ("serve.fit_ms", SERVE, 4.0),                  # mean of 2 and 6
    ("serve.step_idle_ms", SERVE, 2.0),            # 4 ms over 2 batches
    ("serve.batcher_idle_ms", SERVE, 15.5),        # 31 ms over 2 batches
    ("fold.scan_share.serve", SERVE, 25.0),        # 1 of 4 windowable
    ("train.prepare_idle_ms", TRAIN, 6.5),         # 13 ms over 2 steps
    ("train.plan_sync_idle_ms", TRAIN, 25.0),      # gaps 20 + 30 ms
    ("fold.scan_share.train", TRAIN, 100 / 3),     # 1 of 3 windowable
]


def _read(metric, recs, monkeypatch, trace=None, notes=None):
    monkeypatch.setattr(program_spans, "records", lambda: list(recs))
    out = SimpleNamespace(window=SimpleNamespace(
        trace=_trace() if trace is None else trace))
    r = SimpleNamespace(notes={} if notes is None else notes)
    return bench_run.reader(metric)(out, r)


def _per(metric):
    serve = metric.startswith("serve.") or metric.endswith(".serve")
    return "serve.batch" if serve else "train.gen_phase"


@pytest.mark.parametrize("metric, recs, want", READINGS,
                         ids=[m for m, _, _ in READINGS])
def test_reader_arithmetic(metric, recs, want, monkeypatch):
    notes = {}
    got = _read(metric, recs, monkeypatch, notes=notes)
    assert got == pytest.approx(want)
    assert notes["spans"]["in_window"] == sum(
        0 <= r.end_ns <= 100 * MS for r in recs)


@pytest.mark.parametrize("metric", [m for m, _, _ in READINGS])
def test_reader_none_without_a_trace(metric, monkeypatch):
    out = SimpleNamespace(window=SimpleNamespace(trace=None))
    assert bench_run.reader(metric)(out, SimpleNamespace(notes={})) is None


@pytest.mark.parametrize("metric", [m for m, _, _ in READINGS])
def test_reader_none_for_a_program_without_the_recorder(metric,
                                                        monkeypatch,
                                                        tmp_path):
    # the program's utils package as an older program has it: no spans.py
    import pose_transfer_torch.utils as utils
    monkeypatch.delattr(utils, "spans")
    monkeypatch.delitem(sys.modules, spans.RECORDER)
    monkeypatch.setattr(utils, "__path__", [str(tmp_path)])
    out = SimpleNamespace(window=SimpleNamespace(trace=_trace()))
    assert bench_run.reader(metric)(out, SimpleNamespace(notes={})) is None


@pytest.mark.parametrize("metric, recs", [(m, r) for m, r, _ in READINGS])
def test_reader_raises_where_the_gate_recorded_nothing(metric, recs,
                                                       monkeypatch):
    per = _per(metric)
    kept = [r for r in recs if r.name != per]
    with pytest.raises(RuntimeError, match=per):
        _read(metric, kept, monkeypatch)
    # and a window with no record at all
    with pytest.raises(RuntimeError, match=per):
        _read(metric, [], monkeypatch)


def test_idle_within_merges_host_intervals():
    # gaps 0-10, 30-50, 70-100; the host intervals' union 5-25, 30-35,
    # 50-90 overlaps them by 5 + 5 + 20
    ivs = [(5 * MS, 25 * MS), (30 * MS, 35 * MS), (50 * MS, 70 * MS),
           (65 * MS, 90 * MS)]
    assert spans.idle_within(_trace(), ivs) == 30 * MS
    assert spans.idle_within(_trace(), []) == 0


def test_sync_share_leaves_the_head_out():
    recs = [_rec("fold.plan_sync", 0, 5),         # the head gap's start
            _rec("fold.plan_sync", 25, 32),       # holds 30
            _rec("fold.plan_sync", 72, 75)]       # holds none
    got = spans.share_holding_gap_start(_trace(), recs, "fold.plan_sync")
    assert got == pytest.approx(100 / 3)
    assert spans.share_holding_gap_start(_trace(), [], "x") is None


def test_sync_ending_while_the_device_runs_is_counted_out():
    recs = [_rec("fold.plan_sync", 25, 32),       # ends in the 30-50 gap
            _rec("fold.plan_sync", 12, 20)]       # ends while busy
    assert spans.share_ending_in_gap(_trace(), recs,
                                     "fold.plan_sync") == 50.0
    assert spans.share_ending_in_gap(_trace(), [], "x") is None


def test_clock_offsets_against_the_profilers_ranges():
    recs = [_rec("fold.plan_sync", 5, 6), _rec("fold.plan_sync", 95, 96)]
    host = [("fold.plan_sync", 1, 5 * MS - 20_000, 6 * MS),
            ("fold.plan_sync", 1, 95 * MS + 50_000, 96 * MS),
            ("aten::add", 1, 5 * MS, 6 * MS)]
    tr = Trace(0, 100 * MS, DEVICE, host)
    got = spans.clock_offsets_us(tr, recs, "fold.plan_sync")
    assert got["all"] == {"n": 2, "median": -15.0, "max_abs": 50.0}
    assert got["first_tenth"]["median"] == 20.0
    assert got["last_tenth"]["median"] == -50.0
    assert spans.clock_offsets_us(_trace(), recs, "fold.plan_sync") is None


def test_plan_sync_reader_notes_its_share_and_drops(monkeypatch):
    notes = {}
    monkeypatch.setattr(program_spans, "dropped", lambda: 3)
    _read("train.plan_sync_idle_ms", TRAIN, monkeypatch, notes=notes)
    assert notes["spans"]["plan_sync_holding_gap_start_pct"] == \
        pytest.approx(100 / 3)
    assert notes["spans"]["plan_sync_ending_in_gap_pct"] == 100.0
    assert notes["spans"]["dropped"] == 3
    assert notes["spans"]["held"] == len(TRAIN)


def test_no_windowable_fold_reads_zero(monkeypatch):
    recs = [r for r in SERVE if not r.name.startswith("fold.")] + [
        _rec("fold.fwd.28x28", 9, 10, branch="scan")]
    assert _read("fold.scan_share.serve", recs, monkeypatch) == 0.0
