"""Data-parallel train steps over k ranks, for checks.

The counterpart of ``__graft_entry__.dryrun_multichip``: ``train_ranks``
spawns one rank per device, and each rank builds the state from the seed
(or loads given weights), replicates it, and runs the given global batches
through ``make_parallel_train_step`` on its rows. Every rank returns its
nets, the all-reduced metrics, the gathered outputs, its fold kernel
launches and its times, and rank 0 the gradients that each phase handed
its optimizer (``record_grads``), so that a caller can hold the ranks
against each other and against a single-device run
(``tests/test_torch_parallel.py``, ``chip_smoke.py``'s ``data_parallel``
phase).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch

from ..models.networks import ChannelDropout
from ..ops.launches import launch_counts
from ..train.engine import create_state
from .mesh import (ProcessGroup, config_for_mesh, gather_rows,
                   make_parallel_train_step, replicate_state, shard_batch,
                   spawn_ranks, unreplicate_state)


def record_grads(step) -> list:
    """Make ``step`` (a ``TrainStep``) log, at every phase's optimizer
    step, host f32 copies of the gradients the optimizer is given (after
    the data-parallel all-reduce), one list per phase in call order, a
    parameter without a gradient as None. Returns the log."""
    log = []
    sync = step._sync_grads

    def sync_and_record(params):
        params = list(params)
        sync(params)
        log.append([None if p.grad is None else
                    p.grad.detach().to("cpu", torch.float32, copy=True)
                    for p in params])

    step._sync_grads = sync_and_record
    return log


def grad_errors(got: list, want: list, floor: float = 1e-3) -> list:
    """Per phase of two ``record_grads`` logs: ``rel`` = |got − want| /
    |want| over the whole net's gradient (2-norms), and ``worst`` = the
    largest such ratio of one tensor among those whose gradient norm is at
    least ``floor`` × the net's (a tensor with next to no gradient, such as
    a bias ahead of a normalisation, has no meaningful ratio), at index
    ``worst_at`` of the phase's parameters."""
    rows = []
    for a, b in zip(got, want, strict=True):
        if [t is None for t in a] != [t is None for t in b]:
            raise ValueError("the logs' phases hold gradients of other "
                             "parameters")
        pairs = [(i, x.double(), y.double())
                 for i, (x, y) in enumerate(zip(a, b)) if y is not None]
        d2 = [float(((x - y) ** 2).sum()) for _, x, y in pairs]
        n2 = [float((y ** 2).sum()) for _, _, y in pairs]
        net = sum(n2) ** 0.5
        worst, at = max(((d / n) ** 0.5, i) for (i, _, _), d, n
                        in zip(pairs, d2, n2) if n ** 0.5 >= floor * net)
        rows.append({"rel": sum(d2) ** 0.5 / net, "worst": worst,
                     "worst_at": at})
    return rows


def run_job(group: ProcessGroup, job: dict) -> dict:
    """One job on this rank: ``job['config']`` (the global config; its
    ``device_count`` is set to the group's width), ``job['batches']`` (a
    list of (disc_fake, disc_real, gen_batch) global compact batches),
    optional ``job['init']`` ({'gen': state_dict, 'disc': state_dict}, else
    the seeded init of ``job.get('seed', 0)``), ``job.get('dropout',
    True)`` (False: every ChannelDropout at p = 0, which passes its input
    unchanged), ``job.get('snapshots')`` (also the nets' host copies
    after every step) and ``job.get('grads')`` (rank 0 also returns its
    ``record_grads`` log)."""
    cfg = config_for_mesh(job["config"], group)
    state = create_state(cfg, seed=job.get("seed", 0), device=group.device)
    if job.get("init") is not None:
        state.gen.load_state_dict(job["init"]["gen"])
        state.disc.load_state_dict(job["init"]["disc"])
    replicate_state(state, group)
    step = make_parallel_train_step(cfg, state, group, timed=True)
    grads = record_grads(step) if job.get("grads") and group.rank == 0 \
        else None
    if not job.get("dropout", True):
        for m in state.gen.modules():
            if isinstance(m, ChannelDropout):
                m.p = 0.0
    cuda = group.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(group.device)
        torch.cuda.reset_peak_memory_stats(group.device)
    before = launch_counts()
    metrics, step_ms, snapshots = [], [], []
    out = None
    r, k = group.rank, group.world
    for fake, real, gen_batch in job["batches"]:
        t0 = time.perf_counter()
        m, out = step(shard_batch(fake, r, k, 1), shard_batch(real, r, k, 1),
                      shard_batch(gen_batch, r, k, 0))
        if cuda:
            torch.cuda.synchronize(group.device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({n: v.tolist() for n, v in m.items()})
        if job.get("snapshots"):
            snapshots.append(unreplicate_state(state))
    after = launch_counts()
    out = gather_rows(out, group, 1 if cfg.gen_type == "stacked" else 0)
    return {"params": unreplicate_state(state), "snapshots": snapshots,
            "metrics": metrics, "grads": grads,
            "out": out.cpu(), "step_ms": step_ms, "comm_ms": step.comm_ms(),
            "launches": {n: after[n] - before[n] for n in after},
            "peak_mem_gb": torch.cuda.max_memory_allocated(group.device)
            / 2**30 if cuda else None,
            "rank": r, "world": k, "backend": group.backend}


def _rank_main(group: ProcessGroup, jobs: list, out_dir: str) -> None:
    results = [run_job(group, job) for job in jobs]
    torch.save(results, os.path.join(out_dir, f"rank{group.rank}.pt"))


def train_ranks(jobs: list, devices, *, backend: str | None = None,
                timeout: float = 600.0,
                threads: int | None = None) -> list[list[dict]]:
    """Run ``jobs`` (see ``run_job``) on one spawned rank per entry of
    ``devices``; returns ``results[rank][job]``. Raises if a rank fails or
    the ranks outlast ``timeout`` seconds."""
    out_dir = tempfile.mkdtemp(prefix="pt_train_ranks_")
    try:
        spawn_ranks(_rank_main, devices, (jobs, out_dir), backend=backend,
                    timeout=timeout, threads=threads)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(devices))]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
