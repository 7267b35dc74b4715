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

The losses stay on the device as running sums and are fetched only when
the loss line is printed. ``--profile_steps N`` traces N steps from the
second one with ``torch.profiler`` into ``<saveDir>/trace``.

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
from ..data.device import make_batch_preparer
from ..data.loader import sample_stream
from ..train import checkpoint
from ..train.engine import (create_state, make_eval_step, make_train_step,
                            resolve_device)
from ..utils.summary import count_params
from ..utils.visualize import display, save_image
from .opts import Opts, config_from_opt


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


def main(argv=None):
    opt = Opts().parse(argv)
    print("Model options . .")
    for k, v in sorted(vars(opt).items()):
        print("  %s: %s" % (str(k), str(v)))

    device = resolve_device(opt.device)
    config = config_from_opt(opt)
    dataset_train = PoseTransferDataset(vars(opt), "train")
    dataset_test = PoseTransferDataset(vars(opt), "test")

    state = create_state(config, seed=opt.seed, device=device)
    print("---------- Networks initialized -------------")
    print("Generator parameters: %d" % count_params(state.gen))
    print("Discriminator parameters: %d" % count_params(state.disc))
    print("-----------------------------------------------")
    if opt.generator_checkpoint:
        checkpoint.load_params(opt.generator_checkpoint, state.gen)
    if opt.discriminator_checkpoint:
        checkpoint.load_params(opt.discriminator_checkpoint, state.disc)

    start_epoch = 1
    if opt.resume == 1:
        state, start_epoch = checkpoint.resume(state, opt.checkpoints_dir)

    train_step = make_train_step(config, state)
    eval_step = make_eval_step(config, state.gen, device)

    # deterministic resume: skip the batches the completed epochs drew
    # (2·ratio discriminator draws and 1 generator draw per iteration)
    skip = (start_epoch - 1) * opt.iters_per_epoch \
        * (2 * config.training_ratio + 1)
    stream_train = sample_stream(dataset_train, config.batch_size,
                                 seed=opt.seed, prefetch=bool(opt.prefetch),
                                 device=device, skip_batches=skip)
    stream_test = sample_stream(dataset_test, config.batch_size,
                                seed=opt.seed + 1,
                                prefetch=bool(opt.prefetch), device=device)

    metrics_log = open(os.path.join(opt.saveDir, "metrics.jsonl"), "a")
    try:
        _train_epochs(opt, config, state, train_step, eval_step,
                      stream_train, stream_test, metrics_log, start_epoch)
    finally:
        metrics_log.close()
        for s in (stream_train, stream_test):
            s.close()
        # a checkpoint the caller believes saved must exist, or the run
        # fails loudly, also when the loop raised
        checkpoint.wait_for_saves()


def _train_epochs(opt, config, state, train_step, eval_step, stream_train,
                  stream_test, metrics_log, start_epoch):
    prepare = make_batch_preparer(
        image_size=config.image_size, pose_dim=config.pose_dim,
        device=next(state.gen.parameters()).device,
        use_input_pose=config.use_input_pose, warp_skip=config.warp_skip,
        dtype=config.compute_dtype)
    profile_remaining = opt.profile_steps
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
                metrics_log.write(json.dumps({
                    "epoch": epoch, "it": it, "gen_total": g_total,
                    "gen_ll": g_ll, "gen_ad": g_ad, "disc_total": d_total,
                    "disc_true": d_true, "disc_fake": d_fake,
                    "images_per_sec": round(ips, 2),
                    "time": time.time()}) + "\n")
                metrics_log.flush()
                _save_samples(opt, config, prepare, gen_batch, out,
                              eval_step, stream_test, epoch, it)

        if epoch % opt.checkpoint_ratio == 0:
            checkpoint.save(state, opt.checkpoints_dir, epoch, block=False)
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


def _save_samples(opt, config, prepare, gen_batch, out, eval_step,
                  stream_test, epoch, it):
    """Train and test sample grids; ``out`` is the train step's generated
    images of ``gen_batch``."""
    title = "epoch_{0}_{1}.png".format(str(epoch).zfill(3), str(it).zfill(5))
    with torch.no_grad():
        prepared = prepare(gen_batch)
    save_image(os.path.join(opt.output_dir, "train", title),
               display(prepared["input"], prepared["target"], out,
                       config.use_input_pose, config.pose_dim))
    out_t, prepared_t = eval_step(next(stream_test))
    save_image(os.path.join(opt.output_dir, "test", title),
               display(prepared_t["input"], prepared_t["target"], out_t,
                       config.use_input_pose, config.pose_dim))


if __name__ == "__main__":
    main()
