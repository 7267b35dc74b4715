"""Traffic kind ``open_loop``: independent users, each sending one
distinct request (source image, its keypoints, target keypoints) at
Poisson arrivals of a fixed rate, whatever the server's state.

Parameters (``traffic/<mix>.json``): ``batch_size`` and ``max_wait_ms``
of the server; ``rate_per_s``; ``arrival_seed``; ``content_seed``;
``missing_prob``; ``sample``, how many of the window's requests the
output check compares; ``warmup_batches``.

The window holds rate × ``--seconds`` arrivals, their gaps the
exponential distribution's quantiles at (i + 0.5) / n in an order drawn
from ``arrival_seed``. The requests, none repeated, are drawn from
``content_seed`` and sent in an order drawn from ``--seed``. So every
seed offers the same schedule and the same requests in another order,
and the seed does not change how the load bunches or how much work it
is; it changes the weights, the order and the sample compared. Each request is timed from its
scheduled arrival to its resolved future; one that fails or never
resolves misses every limit. The generator's lateness (how long after its
due time a request was submitted) is reported beside.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import measure, serving, synthetic
from ..cell import Outcome, fold_launch_recorder, launch_counts
from ..trace import Window


def schedule(rng: np.random.Generator, rate: float, seconds: float):
    """Due times (s from the window's start) of round(rate × seconds)
    arrivals: the exponential quantiles as gaps, in ``rng``'s order."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return np.cumsum(rng.permutation(gaps))


def run(r) -> Outcome:
    mix = r.mix
    rng = r.rng()
    due = schedule(np.random.default_rng(mix["arrival_seed"]),
                   mix["rate_per_s"], r.seconds)
    n = len(due)
    keep = set(rng.choice(n, size=min(mix["sample"], n), replace=False)
               .tolist())
    size, k, miss = r.image_size, r.pose_dim, mix["missing_prob"]
    content = np.random.default_rng(mix["content_seed"])
    warm = [synthetic.request(content, size, k, miss)
            for _ in range(mix["warmup_batches"] * mix["batch_size"])]
    reqs = [synthetic.request(content, size, k, miss) for _ in range(n)]
    reqs = [reqs[i] for i in rng.permutation(n)]
    srv = serving.start_server(r, mix["batch_size"], mix["max_wait_ms"])
    client = serving.Client(srv, keep)
    client.drain([client.submit(-1 - i, q) for i, q in enumerate(warm)],
                 time.perf_counter() + serving.ANSWER_WAIT_S)
    client.submit_s.clear()
    stats0 = srv.stats()
    serving.settle()
    setup_s = time.perf_counter() - r.t_start

    futs, late = [], np.zeros(n)
    records, undo = fold_launch_recorder() if r.trace else ([], None)
    counts0 = launch_counts()
    try:
        with Window(r.trace, r.device) as win:
            for i in range(n):
                wait = win.t0 + due[i] - time.perf_counter()
                if wait > 0:
                    with torch.profiler.record_function("bench.client.idle"):
                        time.sleep(wait)
                late[i] = time.perf_counter() - win.t0 - due[i]
                futs.append(client.submit(i, reqs[i]))
            client.drain(futs, win.t0 + r.seconds + serving.ANSWER_WAIT_S)
    finally:
        if undo is not None:
            undo()
    fill = serving.batch_fill(srv, stats0)
    counts = {k: v - counts0[k] for k, v in launch_counts().items()}
    srv.close()
    peak = torch.cuda.max_memory_allocated(r.device) \
        if r.device.type == "cuda" else 0
    answered = client.answered()
    lat = np.array([answered.get(i, np.inf) - win.t0 - due[i]
                    for i in range(n)])
    served = dict(client.kept)
    submit_ms = 1e3 * float(np.mean(client.submit_s))
    failed = int(np.isinf(lat).sum())
    del srv, client, futs
    serving.free()

    gap, info = serving.image_check(r, {i: reqs[i] for i in keep}, served)
    return Outcome(
        setup_s=setup_s, window=win, memory_peak_bytes=peak,
        attempted=n, failed=failed,
        e2e={"serve_p95_ms": measure.percentile_ms(lat, 95)},
        checks=[("image_gap", gap)],
        readings={"submit_ms": submit_ms, "batch_fill": fill,
                  "launch_records": records},
        info={**info, "counters": counts, "offered_per_s": mix["rate_per_s"],
              "p50_ms": measure.percentile_ms(lat, 50),
              "p99_ms": measure.percentile_ms(lat, 99),
              "late_ms_mean": 1e3 * float(late.mean()),
              "late_ms_max": 1e3 * float(late.max()),
              "window_s": win.seconds})
