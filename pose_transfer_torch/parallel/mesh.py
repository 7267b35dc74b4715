"""Data-parallel runs over several devices.

Counterpart of ``pose_transfer_tpu/parallel/mesh.py``. The JAX package runs
one process over a 1-D device mesh: parameters replicated, every batch
sharded on its batch axis, and XLA inserts the gradient all-reduce. The
port takes PyTorch's idiom and keeps the JAX package's flags and numerics:

- training runs one process per device, a *rank* (``spawn_ranks``,
  ``ProcessGroup``): ``nccl`` on ``cuda:<rank>``, ``gloo`` on the CPU or
  where ranks share one card (NCCL refuses two ranks on one GPU). Every
  rank builds the same state from one seed, rank 0 broadcasts it
  (``replicate_state``), each rank steps on its rows of the global batch
  (``shard_batch``) and the gradients are all-reduced after each phase's
  backward, before its optimizer step (``make_parallel_train_step``);
- inference runs in one process, one generator replica per device, each
  micro-batch split over them (``make_parallel_eval_step``), as the JAX
  package's mesh eval step and its server do.

The loss convention: each rank computes the losses of its rows as the
single-device step computes a batch's (means, and sums over the batch
divided by its rows), the gradients and the losses are averaged over the
ranks. With equal shares that is the global batch's loss, as JAX's
``make_parallel_train_step`` computes it (``tests/test_torch_parallel.py``
holds both against each other).

The JAX package's ``fold_mesh`` (``ops/warp.py:96-135``) has no counterpart:
it keeps GSPMD from folding a sharded batch as a replicated one. A rank
folds only its local batch, and decides the windowed fold's fit on it.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import torch
import torch.distributed as dist

from ..models.networks import ChannelDropout
from ..train.engine import GANConfig, TrainState, TrainStep, make_eval_step

# rendezvous and collectives fail after this many seconds instead of
# hanging a run whose other rank died
TIMEOUT_S = 300.0
# gradient all-reduce buckets (elements): the 82 M-parameter generator
# reduces in 4 calls
BUCKET_ELEMS = 25 * 2**20


@dataclasses.dataclass(frozen=True)
class ProcessGroup:
    """This process's rank in the default process group, and its device."""
    backend: str
    rank: int
    world: int
    device: torch.device

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def default_backend(devices: Sequence) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    own_cards = all(d.type == "cuda" and d.index is not None for d in devs) \
        and len({d.index for d in devs}) == len(devs)
    return "nccl" if own_cards else "gloo"


def init_group(rank: int, world: int, device, init_file: str,
               backend: str | None = None,
               timeout_s: float = TIMEOUT_S) -> ProcessGroup:
    """Join the default process group by rendezvous on ``init_file`` (a
    path that no earlier group used: tests under xdist never contend for a
    TCP port). Raises when the other ranks do not arrive in time."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or default_backend([device])
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return ProcessGroup(backend, rank, world, device)


def close_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(rank, fn, devices, backend, init_file, threads, args):
    if threads:
        torch.set_num_threads(threads)
    group = init_group(rank, len(devices), devices[rank], init_file, backend)
    try:
        fn(group, *args)
    finally:
        close_group()


def spawn_ranks(fn, devices: Sequence, args: tuple = (), *,
                backend: str | None = None, timeout: float | None = None,
                threads: int | None = None) -> None:
    """Run ``fn(group, *args)`` on one spawned process per entry of
    ``devices`` (rank r on ``devices[r]``) and join them. ``fn`` must be a
    module-level function. Raises if a rank fails (the others are stopped)
    or, with ``timeout`` (s), if the ranks have not ended by then; every
    process is gone when this returns. ``threads``: torch's intra-op
    threads in each rank."""
    devices = [str(d) for d in devices]
    backend = backend or default_backend(devices)
    tmp = tempfile.mkdtemp(prefix="pt_ranks_")
    ctx = torch.multiprocessing.start_processes(
        _rank_entry, args=(fn, devices, backend, os.path.join(tmp, "store"),
                           threads, args),
        nprocs=len(devices), join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{len(devices)} ranks still running "
                                   f"after {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------- the config

def _width(mesh) -> int:
    """Devices of ``mesh``: None (1), a ``ProcessGroup``, a device list or
    a count."""
    if mesh is None:
        return 1
    if isinstance(mesh, ProcessGroup):
        return mesh.world
    if isinstance(mesh, int):
        return mesh
    return len(mesh)


def config_for_mesh(config: GANConfig, mesh) -> GANConfig:
    """Return ``config`` with ``device_count`` set to the mesh width.

    Call this BEFORE ``build_models``/``create_state``: the auto
    ``warp_windowed`` rule keys off the PER-DEVICE batch. ``mesh`` is a
    ``ProcessGroup``, a list of devices, a count, or None (single device:
    device_count 1).
    """
    return dataclasses.replace(config, device_count=_width(mesh))


def _check_mesh_config(config: GANConfig, mesh, what: str) -> None:
    n = _width(mesh)
    if config.device_count != n:
        raise ValueError(
            f"{what}: config.device_count={config.device_count} but the "
            f"mesh has {n} device(s). Build the "
            f"models from config_for_mesh(config, mesh) — the auto "
            f"warp_windowed rule must see the data-parallel width")


def _check_divides(config: GANConfig, n: int) -> None:
    if config.batch_size % n:
        raise ValueError(f"batch_size {config.batch_size} must divide over "
                         f"{n} mesh devices")


# ------------------------------------------------------- state and batches

def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor the ranks must hold alike, in one order on every rank:
    both nets' parameters and buffers, both optimizers' states."""
    out = [*state.gen.state_dict().values(), *state.disc.state_dict().values()]
    for opt in (state.gen_opt, state.disc_opt):
        for pg in opt.param_groups:
            for p in pg["params"]:
                st = opt.state.get(p, {})
                out += [st[k] for k in sorted(st)
                        if isinstance(st[k], torch.Tensor)]
    return out


def _broadcast(t: torch.Tensor, group: ProcessGroup) -> None:
    """Rank 0's ``t`` into every rank's ``t``, in place."""
    buf = t if t.device == group.device else t.to(group.device)
    dist.broadcast(buf, src=0)
    if buf is not t:
        t.copy_(buf)


def _checksums(tensors, group: ProcessGroup) -> torch.Tensor:
    dev = group.device if group.backend == "nccl" else torch.device("cpu")
    return torch.stack([t.detach().to(dev, torch.float64).sum()
                        for t in tensors])


def replicate_state(state: TrainState, group: ProcessGroup) -> TrainState:
    """Make every rank's state rank 0's: both nets, both optimizer states
    and the dropout generator, broadcast in place; then a checksum of every
    tensor, compared over the ranks, confirms that all ranks agree (raises
    otherwise). Build ``state`` from one seed on every rank first (or read
    the same checkpoint on every rank)."""
    tensors = _state_tensors(state)
    for t in tensors:
        _broadcast(t, group)
    rng = state.rng.get_state()
    _broadcast(rng, group)
    state.rng.set_state(rng)
    sums = _checksums([*tensors, rng], group)
    lo, hi = sums.clone(), sums.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    if not torch.equal(lo, hi):
        bad = int((lo != hi).sum())
        raise RuntimeError(f"rank {group.rank}: {bad} of {len(sums)} state "
                           "tensors differ between the ranks after the "
                           "broadcast")
    return state


def unreplicate_state(state: TrainState) -> dict:
    """Host copies of a replica's nets, ``{'gen': state_dict, 'disc':
    state_dict}``; every rank holds rank 0's (``replicate_state`` and the
    all-reduced updates keep them bitwise equal)."""
    return {k: {n: t.detach().to("cpu", copy=True)
                for n, t in net.state_dict().items()}
            for k, net in (("gen", state.gen), ("disc", state.disc))}


def shard_batch(batch: dict, rank: int, world: int, axis: int = 0) -> dict:
    """Rank ``rank``'s rows of a compact batch: axis 1 for the
    discriminator draws (leading ``training_ratio`` axis), axis 0 for the
    generator batch. The counterpart of JAX's ``batch_shardings``. Raises
    when the rows do not divide over ``world``."""
    n = next(iter(batch.values())).shape[axis]
    if n % world:
        raise ValueError(f"batch of {n} rows does not divide over {world} "
                         "ranks")
    m = n // world
    index = (slice(None),) * axis + (slice(rank * m, (rank + 1) * m),)
    return {k: v[index] for k, v in batch.items()}


def gather_rows(t: torch.Tensor, group: ProcessGroup,
                dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated on ``dim`` in rank order (a
    collective: all ranks call it), in ``t``'s dtype."""
    buf = t.detach().float().contiguous()
    parts = [torch.empty_like(buf) for _ in range(group.world)]
    dist.all_gather(parts, buf)
    return torch.cat(parts, dim=dim).to(t.dtype)


# ------------------------------------------------------------- train step

def _buckets(tensors: list, limit: int):
    """Consecutive runs of ``tensors`` of at most ``limit`` elements (a
    larger tensor alone)."""
    bucket, size = [], 0
    for t in tensors:
        if bucket and size + t.numel() > limit:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


class ParallelTrainStep(TrainStep):
    """``TrainStep`` on this rank's rows (``shard_batch``) of a global batch
    of ``config.batch_size``: the losses of those rows, the gradients of
    each phase all-reduced (summed in ``BUCKET_ELEMS`` buckets, divided by
    the ranks) between its backward and its optimizer step, one all-reduce
    per update as in JAX; the metrics averaged over the ranks, so that
    every rank reports the global losses. With ``timed``, ``comm_ms`` is
    the time spent in the gradient all-reduces (CUDA events on a card)."""

    def __init__(self, config: GANConfig, state: TrainState,
                 group: ProcessGroup, timed: bool = False):
        local = dataclasses.replace(
            config, batch_size=config.batch_size // group.world)
        super().__init__(local, state)
        self.group = group
        self.timed = timed
        self._events: list = []
        self._ms = 0.0
        for m in state.gen.modules():
            if isinstance(m, ChannelDropout):
                m.shard = (group.rank, group.world)

    def _all_reduce(self, grads: list) -> None:
        for bucket in _buckets(grads, BUCKET_ELEMS):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat)
            flat /= self.group.world
            off = 0
            for g in bucket:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

    def _sync_grads(self, params) -> None:
        grads = [p.grad for p in params if p.grad is not None]
        if not self.timed:
            self._all_reduce(grads)
        elif self.group.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in "se")
            start.record()
            self._all_reduce(grads)
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            self._all_reduce(grads)
            self._ms += (time.perf_counter() - t0) * 1e3

    def comm_ms(self) -> float:
        """Milliseconds spent in the gradient all-reduces so far (0 unless
        ``timed``)."""
        if self._events:
            torch.cuda.synchronize(self.group.device)
            self._ms += sum(s.elapsed_time(e) for s, e in self._events)
            self._events.clear()
        return self._ms

    def __call__(self, disc_fake: dict, disc_real: dict, gen_batch: dict):
        metrics, out = super().__call__(disc_fake, disc_real, gen_batch)
        vec = torch.cat([metrics["gen"], metrics["disc"]]).float()
        dist.all_reduce(vec)
        vec /= self.group.world
        return {"gen": vec[:3], "disc": vec[3:]}, out


def make_parallel_train_step(config: GANConfig, state: TrainState,
                             group: ProcessGroup,
                             timed: bool = False) -> ParallelTrainStep:
    """The two-phase step of this rank (``ParallelTrainStep``): per-rank
    batch ``batch_size // world``; call it with this rank's rows."""
    _check_mesh_config(config, group, "make_parallel_train_step")
    _check_divides(config, group.world)
    return ParallelTrainStep(config, state, group, timed)


# ------------------------------------------------------------------- eval

def make_parallel_eval_step(config: GANConfig, gen: torch.nn.Module,
                            devices: Sequence):
    """Batch-split inference forward in one process → (images, prepared
    batch), as ``make_eval_step``'s.

    One replica of ``gen`` per entry of ``devices`` (``gen`` itself on the
    first, copies on the others; a card may be named twice), each compact
    batch split in rank order over them, one worker thread per device (the
    fold's plan syncs the host once a forward, so one thread would
    serialise the devices), the outputs gathered on the first device:
    (N, H, W, 3), or for the stacked generator (S, N, H, W, 3) with the
    batch on axis 1.
    """
    devices = [torch.device(d) for d in devices]
    _check_mesh_config(config, devices, "make_parallel_eval_step")
    _check_divides(config, len(devices))
    replicas = [gen] + [copy.deepcopy(gen) for _ in devices[1:]]
    steps = [make_eval_step(config, r, d) for r, d in zip(replicas, devices)]
    pool = ThreadPoolExecutor(max_workers=len(devices),
                              thread_name_prefix="eval_replica")
    out_dim = 1 if config.gen_type == "stacked" else 0
    home = devices[0]

    def run(step, device, batch):
        if device.type == "cuda":
            with torch.cuda.device(device):
                out, prepared = step(batch)
                torch.cuda.current_stream(device).synchronize()
                return out, prepared
        return step(batch)

    def eval_step(batch_raw: dict):
        k = len(devices)
        futs = [pool.submit(run, steps[i], devices[i],
                            shard_batch(batch_raw, i, k)) for i in range(k)]
        results = [f.result() for f in futs]
        out = torch.cat([o.to(home) for o, _ in results], dim=out_dim)
        prepared = {k: None if v is None else
                    torch.cat([p[k].to(home) for _, p in results])
                    for k, v in results[0][1].items()}
        return out, prepared

    eval_step.replicas = replicas
    return eval_step

