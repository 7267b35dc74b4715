"""Traffic kind ``closed_loop``: a batch job that keeps a fixed number of
requests outstanding from one client thread; each answer lets the next
request go.

Parameters (``traffic/<mix>.json``): ``batch_size`` and ``max_wait_ms``
of the server; ``outstanding``; ``job_frames``, the frames of a motion
job (one source image and its keypoints, target poses along a path
between two skeletons); ``content_seed``; ``jobs``, how many jobs are
drawn; ``warmup_answers``, answers before the window opens (the loop's
own ramp); ``sample`` and ``sample_span``: how many requests the output
check compares, drawn from the first ``sample_span`` after the warm-up.

The jobs are drawn from ``content_seed`` and run frame by frame in a job
order drawn from ``--seed``, from the start again when all are sent, so a
faster program never runs out: every seed renders the same jobs (a job's
poses decide whether a fold falls back to the full scan, so jobs of
their own per seed would change the work), in another order. The window
counts the images returned to resolved futures between its two ends.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import serving, synthetic
from ..cell import Outcome, fold_launch_recorder, launch_counts
from ..trace import Window


def run(r) -> Outcome:
    mix = r.mix
    rng = r.rng()
    warm, jobs = mix["warmup_answers"], mix["jobs"]
    content = np.random.default_rng(mix["content_seed"])
    drawn = [synthetic.motion_job(content, r.image_size, r.pose_dim,
                                  mix["job_frames"]) for _ in range(jobs)]
    reqs = [q for j in rng.permutation(jobs) for q in drawn[j]]
    keep = set((warm + rng.choice(mix["sample_span"], size=mix["sample"],
                                  replace=False)).tolist())
    srv = serving.start_server(r, mix["batch_size"], mix["max_wait_ms"])
    client = serving.Client(srv, keep)
    pending = collections.deque()
    nxt = 0

    def send():
        nonlocal nxt
        pending.append(client.submit(nxt, reqs[nxt % len(reqs)]))
        nxt += 1

    def turn():
        """Wait for the oldest request, then send the next one."""
        with torch.profiler.record_function("bench.client.wait"):
            pending.popleft().exception()
        send()

    for _ in range(mix["outstanding"]):
        send()
    while nxt < warm + mix["outstanding"]:
        turn()
    stats0 = srv.stats()
    serving.settle()
    setup_s = time.perf_counter() - r.t_start

    records, undo = fold_launch_recorder() if r.trace else ([], None)
    counts0 = launch_counts()
    try:
        with Window(r.trace, r.device) as win:
            while win.elapsed() < r.seconds:
                turn()
    finally:
        if undo is not None:
            undo()
    done = [t for t in client.answered().values() if win.t0 <= t <= win.t1]
    stats1 = srv.stats()
    counts = {k: v - counts0[k] for k, v in launch_counts().items()}
    client.drain(list(pending), time.perf_counter() + serving.ANSWER_WAIT_S)
    srv.close()
    peak = torch.cuda.max_memory_allocated(r.device) \
        if r.device.type == "cuda" else 0
    served = dict(client.kept)
    sent = nxt - warm - mix["outstanding"]
    failed = nxt - len(client.answered())
    del srv, client, pending
    serving.free()

    # a sampled request the loop never sent was not due in the window
    gap, info = serving.image_check(
        r, {i: reqs[i % len(reqs)] for i in keep if i < nxt}, served)
    return Outcome(
        setup_s=setup_s, window=win, memory_peak_bytes=peak,
        attempted=sent, failed=failed,
        e2e={"serve_img_per_s": len(done) / win.seconds},
        checks=[("image_gap", gap)],
        readings={"images": len(done),
                  "batches": stats1["batches"] - stats0["batches"],
                  "launch_records": records},
        info={**info, "counters": counts, "images": len(done), "sent": sent,
              "jobs_drawn": jobs, "window_s": win.seconds})
