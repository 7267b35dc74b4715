"""The traffic generators: the same seed gives the same traffic, another
seed another; the copies draw as the program's generators do; every seed
gets the same arrival gaps in another order."""

import numpy as np
import pytest

from portbench import synthetic
from portbench.cell import Run
from portbench.traffic import open_loop, train_steps


def _run(seed, mix, config=None):
    import torch
    config = config or {"image_size": [64, 64], "pose_dim": 18}
    return Run(cell="c", config=config, mix=mix, limits={}, seed=seed,
               seconds=5.0, trace=False, device=torch.device("cpu"),
               t_start=0.0)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def test_train_pool_repeats_per_seed_and_keeps_its_rows():
    mix = {"pool": 3, "missing_prob": 0.0, "content_seed": 0}
    big = 2**31 + 12345
    a = train_steps._pool(_run(big, mix), 2)
    b = train_steps._pool(_run(big, mix), 2)
    c = train_steps._pool(_run(big + 3, mix), 2)
    assert _same(a, b)
    # another seed: the same triples in another order
    assert not _same(a, c)
    key = lambda t: t[2]["image_from"].tobytes()  # noqa: E731
    assert sorted(map(key, a)) == sorted(map(key, c))
    # every row of the pool differs: the compared steps see distinct rows
    rows = [r for triple in a for part in triple
            for r in part["image_from"].reshape(-1, 64 * 64 * 3)]
    assert len({r.tobytes() for r in rows}) == len(rows)


def test_open_loop_schedule_repeats_and_keeps_its_gaps():
    a = open_loop.schedule(np.random.default_rng(1), 60.0, 20.0)
    b = open_loop.schedule(np.random.default_rng(1), 60.0, 20.0)
    c = open_loop.schedule(np.random.default_rng(2), 60.0, 20.0)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == 1200
    # the same set of gaps in another order, and the mean rate offered
    gaps = lambda d: np.sort(np.diff(np.concatenate([[0.0], d])))  # noqa
    assert np.allclose(gaps(a), gaps(c))
    assert abs(a[-1] - 20.0) < 0.5


def test_motion_job_shares_its_source():
    rng = np.random.default_rng(3)
    job = synthetic.motion_job(rng, (64, 64), 16, 8)
    assert len(job) == 8
    assert all(q[0] is job[0][0] and q[1] is job[0][1] for q in job)
    assert not np.array_equal(job[0][2], job[-1][2])
    again = synthetic.motion_job(np.random.default_rng(3), (64, 64), 16, 8)
    assert _same(job, again)


@pytest.mark.parametrize("k", [16, 18])
def test_copies_draw_as_the_program_does(k):
    from pose_transfer_torch.data import synthetic as prog
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        assert np.array_equal(synthetic.random_skeleton(a, (96, 64), k),
                              prog.random_skeleton(b, (96, 64), k))
        assert np.array_equal(synthetic.random_image(a, (96, 64)),
                              prog.random_image(b, (96, 64)))
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    ours = synthetic.compact_batch(a, 2, (64, 64), k)
    theirs = prog.synthetic_compact_batch(b, 2, (64, 64), k)
    assert _same(ours, theirs)


def test_closed_loop_cycles_its_jobs(small):
    """A program faster than the drawn jobs last sends them again in the
    seed's order; the run comes out whole and correct."""
    import time

    from portbench import run
    spec = small("h36m224-serve-offline-b32")
    spec["mix"].update(jobs=1, job_frames=4)
    res = run.execute(spec, 2**31 + 31, 1.0, False, "cpu",
                      time.perf_counter())
    assert res["info"]["sent"] + spec["mix"]["warmup_answers"] \
        + spec["mix"]["outstanding"] > 4
    assert res["result"]["correct"]
