"""Training entry point.

Counterpart of ``pose_transfer_tpu/cli/main.py``, with its observable
behaviour: an epoch loop of ``iters_per_epoch`` iterations; per iteration
``training_ratio`` discriminator updates (each on two independent draws, a
fake-path and a real one), then one generator update; every
``display_ratio`` iterations the running-mean loss line with img/s, a
``metrics.jsonl`` record and the train and test sample grids; checkpoints
every ``checkpoint_ratio`` epochs, written in the background; ``--resume``
restarts at the latest checkpoint's epoch and seeks the train stream past
the batches the earlier epochs drew.

With ``--gen_type stacked`` and no ``--generator_checkpoint``, the shared
generator warm-starts from the latest ``gen_*.pt`` (else ``gen_*.msgpack``,
the JAX package's) of the deformable run
``<exp_root>/full_<dataset>/models`` where there is one, and its grids
show every stage. ``--resume 1``, ``--generator_checkpoint`` and
``--discriminator_checkpoint`` read the port's ``.pt`` files and the JAX
package's ``.msgpack`` files alike (``train.checkpoint``).
``--content_loss_layer`` reads ``--vgg_weights`` (a
torch VGG19 state_dict) where given, else seeded random filters.

The losses stay on the device as running sums and are fetched only when
the loss line is printed. ``--profile_steps N`` traces N steps from the
second one with ``torch.profiler`` into ``<saveDir>/trace``.

``--num_devices k`` (``opts.mesh_from_opt``) trains data-parallel: the
kernels are built once, then k spawned ranks (``parallel.spawn_ranks``)
each run the loop on their rows of every global batch
(``parallel.make_parallel_train_step``). Rank 0 prints, writes
``metrics.jsonl``, saves the checkpoints and renders the grids, for which
the ranks gather their rows; a rank that fails fails the command.

Run: ``python -m pose_transfer_torch.cli.main --expID ... --data_Dir ...
[--device cpu]``
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..data.dataset import PoseTransferDataset
from ..data.loader import sample_stream
from ..parallel import mesh
from ..train import checkpoint
from ..train.engine import (batch_preparer, create_state, make_eval_step,
                            make_train_step, resolve_device)
from ..utils.summary import count_params
from ..utils.visualize import display, display_stacked, save_image
from .opts import Opts, config_from_opt, mesh_from_opt


def _stack_batches(batches: list[dict]) -> dict:
    stack = torch.stack if isinstance(batches[0]["image_from"],
                                      torch.Tensor) else np.stack
    return {k: stack([b[k] for b in batches]) for k in batches[0]}


def draw_step_batches(stream, training_ratio: int):
    """(disc_fake, disc_real, gen_batch) for one train step: the
    reference's per-iteration draws."""
    fake = [next(stream) for _ in range(training_ratio)]
    real = [next(stream) for _ in range(training_ratio)]
    gen_batch = next(stream)
    return _stack_batches(fake), _stack_batches(real), gen_batch


def main(argv=None, *, rank_timeout: float | None = None):
    """``rank_timeout`` (s): with ``--num_devices`` > 1, fail the run if
    the ranks have not ended by then (default: no limit)."""
    opt = Opts().parse(argv)
    print("Model options . .")
    for k, v in sorted(vars(opt).items()):
        print("  %s: %s" % (str(k), str(v)))

    config = config_from_opt(opt)
    devices = mesh_from_opt(opt, config)
    if devices is None:
        train(opt, config, resolve_device(opt.device))
        return
    # device_count drives the auto warp_windowed rule (per-device batch)
    config = mesh.config_for_mesh(config, devices)
    print(f"Data-parallel over {len(devices)} ranks: {devices}")
    sys.stdout.flush()
    if any(d.startswith("cuda") for d in devices):
        from .. import _build
        _build.build_all()      # once, before the ranks load the kernels
    # CPU ranks share the host's cores
    threads = max(1, torch.get_num_threads() // len(devices)) \
        if devices[0] == "cpu" else None
    mesh.spawn_ranks(_rank_train, devices, (opt, config), threads=threads,
                     timeout=rank_timeout)


def _rank_train(group, opt, config) -> None:
    if group.rank:
        sys.stdout = open(os.devnull, "w")
    train(opt, config, group.device, group)


def train(opt, config, device, group=None) -> None:
    """The training run of ``opt`` on ``device``; with ``group`` (a
    ``parallel.ProcessGroup``) this rank's part of a data-parallel run."""
    dataset_train = PoseTransferDataset(vars(opt), "train")
    dataset_test = PoseTransferDataset(vars(opt), "test")

    vgg = None
    if config.content_loss_layer != "none" and opt.vgg_weights:
        from ..models.vgg import load_torch_vgg19_features
        vgg = load_torch_vgg19_features(opt.vgg_weights, device)
    state = create_state(config, seed=opt.seed, device=device, vgg=vgg)
    print("---------- Networks initialized -------------")
    print("Generator parameters: %d" % count_params(state.gen))
    print("Discriminator parameters: %d" % count_params(state.disc))
    print("-----------------------------------------------")
    if opt.generator_checkpoint:
        checkpoint.load_params(opt.generator_checkpoint, state.gen)
    if opt.discriminator_checkpoint:
        checkpoint.load_params(opt.discriminator_checkpoint, state.disc)
    if config.gen_type == "stacked" and not opt.generator_checkpoint:
        _warm_start_stacked(opt, state)

    start_epoch = 1
    if opt.resume == 1:
        state, start_epoch = checkpoint.resume(state, opt.checkpoints_dir,
                                               seed=opt.seed)

    if group is None:
        train_step = make_train_step(config, state)
        rank, world = 0, 1
    else:
        mesh.replicate_state(state, group)
        train_step = mesh.make_parallel_train_step(config, state, group)
        rank, world = group.rank, group.world
    eval_step = make_eval_step(config, state.gen, device)

    # deterministic resume: skip the batches the completed epochs drew
    # (2·ratio discriminator draws and 1 generator draw per iteration)
    skip = (start_epoch - 1) * opt.iters_per_epoch \
        * (2 * config.training_ratio + 1)
    stream_train = sample_stream(dataset_train, config.batch_size,
                                 seed=opt.seed, prefetch=bool(opt.prefetch),
                                 device=device, skip_batches=skip,
                                 rank=rank, world=world)
    stream_test = sample_stream(dataset_test, config.batch_size,
                                seed=opt.seed + 1,
                                prefetch=bool(opt.prefetch), device=device,
                                rank=rank, world=world)

    metrics_log = open(os.path.join(opt.saveDir, "metrics.jsonl"), "a") \
        if rank == 0 else None
    try:
        _train_epochs(opt, config, state, train_step, eval_step,
                      stream_train, stream_test, metrics_log, start_epoch,
                      group)
    finally:
        if metrics_log is not None:
            metrics_log.close()
        for s in (stream_train, stream_test):
            s.close()
        # a checkpoint the caller believes saved must exist, or the run
        # fails loudly, also when the loop raised
        checkpoint.wait_for_saves()


def _warm_start_stacked(opt, state) -> None:
    """Best effort, as the JAX package's CLI: the stacked generator's shared
    generator from the deformable run ``full_<dataset>``'s latest
    checkpoint (the reference requires that run)."""
    warm_dir = os.path.join(opt.exp_root, f"full_{opt.dataset}", "models")
    warm = checkpoint.latest(warm_dir, "gen")
    if warm:
        checkpoint.load_params(warm, state.gen.generator)
        print(f"Warm-started stacked generator from {warm}")
    else:
        print(f"No pretrained generator under {warm_dir}; "
              "training stacked generator from scratch")


def _train_epochs(opt, config, state, train_step, eval_step, stream_train,
                  stream_test, metrics_log, start_epoch, group=None):
    prepare = batch_preparer(config, next(state.gen.parameters()).device)
    # the profiler traces rank 0's steps
    profile_remaining = opt.profile_steps if metrics_log is not None else 0
    profiler = None
    for epoch in range(start_epoch, opt.number_of_epochs + 1):
        gen_sum = disc_sum = None
        loss_count = 0
        num_iterations = opt.iters_per_epoch
        print("Num iterations : ", num_iterations)
        epoch_t0 = time.time()

        for it in range(num_iterations):
            if profile_remaining and profiler is None and it == 1:
                # step 0 builds and tunes; trace the steady state
                profiler = _start_profiler(state)
            fake, real, gen_batch = draw_step_batches(
                stream_train, config.training_ratio)
            metrics, out = train_step(fake, real, gen_batch)
            # running sums on the device: one fetch per display
            gen_sum = metrics["gen"] if gen_sum is None \
                else gen_sum + metrics["gen"]
            disc_sum = metrics["disc"] if disc_sum is None \
                else disc_sum + metrics["disc"]
            loss_count += 1
            if profiler is not None and profile_remaining:
                profile_remaining -= 1
                if profile_remaining == 0:
                    _stop_profiler(profiler, opt.saveDir)

            if it % opt.display_ratio == 0:
                g_total, g_ll, g_ad = (gen_sum / loss_count).tolist()
                d_total, d_true, d_fake = (disc_sum / loss_count).tolist()
                total = g_total + d_total
                elapsed = time.time() - epoch_t0
                ips = (it + 1) * config.batch_size * \
                    (2 * config.training_ratio + 1) / max(elapsed, 1e-9)
                print("Epoch : {8:d} | Progress : {0:.2f} | Total Loss : "
                      "{1:.4f} | Gen Total Loss : {2:.4f}, Gen Ad Loss : "
                      "{3:.4f}, Gen LL Loss : {4:.4f}  | Disc Total Loss : "
                      "{5:.4f}, Disc True Loss : {6:.4f}, Disc Fake Loss : "
                      "{7:.4f} | img/s : {9:.1f}".format(
                          it / num_iterations, total, g_total, g_ad, g_ll,
                          d_total, d_true, d_fake, epoch, ips))
                sys.stdout.flush()
                if metrics_log is not None:
                    metrics_log.write(json.dumps({
                        "epoch": epoch, "it": it, "gen_total": g_total,
                        "gen_ll": g_ll, "gen_ad": g_ad,
                        "disc_total": d_total, "disc_true": d_true,
                        "disc_fake": d_fake,
                        "images_per_sec": round(ips, 2),
                        "time": time.time()}) + "\n")
                    metrics_log.flush()
                _save_samples(opt, config, prepare, gen_batch, out,
                              eval_step, stream_test, epoch, it, group)

        if epoch % opt.checkpoint_ratio == 0:
            checkpoint.save(state, opt.checkpoints_dir, epoch, block=False,
                            group=group)
    if profiler is not None and profile_remaining:
        _stop_profiler(profiler, opt.saveDir)     # fewer steps than asked


def _start_profiler(state):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if next(state.gen.parameters()).is_cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, save_dir: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    trace_dir = os.path.join(save_dir, "trace")
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    print("Wrote profiler trace to", trace_dir)


def sample_grid(config, prepared: dict, out) -> np.ndarray:
    """A batch's grid: ``display``, or for the stacked generator
    ``display_stacked`` over its (S, N, H, W, 3) stages."""
    if config.gen_type != "stacked":
        return display(prepared["input"], prepared["target"], out,
                       config.use_input_pose, config.pose_dim)
    return display_stacked(prepared["input"], prepared["interpol_pose"],
                           prepared["target"], out, config.num_stacks,
                           config.use_input_pose, config.pose_dim)


def _gathered(config, prepared: dict, out, group):
    """A data-parallel step's rows of the grid's inputs, gathered from every
    rank in rank order (a collective); as given on one device."""
    if group is None:
        return prepared, out
    keys = ("input", "target", "interpol_pose")
    prepared = {k: mesh.gather_rows(prepared[k], group)
                for k in keys if prepared.get(k) is not None}
    dim = 1 if config.gen_type == "stacked" else 0
    return prepared, mesh.gather_rows(out, group, dim)


def _save_samples(opt, config, prepare, gen_batch, out, eval_step,
                  stream_test, epoch, it, group=None):
    """Train and test sample grids; ``out`` is the train step's generated
    images of ``gen_batch``; in a data-parallel run rank 0 writes them."""
    title = "epoch_{0}_{1}.png".format(str(epoch).zfill(3), str(it).zfill(5))
    with torch.no_grad():
        prepared = prepare(gen_batch)
    grids = [("train", *_gathered(config, prepared, out, group))]
    out_t, prepared_t = eval_step(next(stream_test))
    grids.append(("test", *_gathered(config, prepared_t, out_t, group)))
    if group is not None and group.rank:
        return
    for split, prep, images in grids:
        save_image(os.path.join(opt.output_dir, split, title),
                   sample_grid(config, prep, images))


if __name__ == "__main__":
    main()
