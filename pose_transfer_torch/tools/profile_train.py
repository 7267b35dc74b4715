"""Where a training step spends its device time.

    python3 -m pose_transfer_torch.tools.profile_train [--batch 8 32]
        [--warp_backend {matmul,pallas}] [--dataset {fasion,h36m}]
        [--gen_type {baseline,stacked,unet}]
        [--content_loss_layer block1_conv2]

For each batch size, builds the full-width training state of the dataset
(``fasion``: 256², pose_dim 18; ``h36m``: 224², pose_dim 16, the 6-stage
ladder; generator and discriminator, bf16, seeded random weights,
``create_state``; ``--warp_backend pallas`` puts the fold stages the fused
warp fold takes on it; ``--gen_type`` the deformable, stacked (4 stages)
or U-Net generator; ``--content_loss_layer`` the reference's full_fasion
recipe, ``profile_serve.config_for``) and the two-phase step
(``make_train_step``), and reports as JSON lines, each naming the
backend, dataset, generator type and content layer:
- the step: device ms (CUDA events around each step, mean over 5 steps after
  2 warm-up steps), host wall ms, train img/s from the wall time and from
  the device time, and peak device memory. Images per step are counted as
  N·(2·training_ratio + 1), the generator forwards' inputs, as the JAX
  package's bench counts them;
- a ``torch.profiler`` trace of two steps: device time by kernel category
  (``profile_serve._category``), the device's idle share within the traced
  span (``profile_serve._idle_share``) and the top kernels;
- the layers, from the same trace (``profile_serve._span_ms``): per step,
  each of the program's spans (``utils.spans``: the two phases, batch
  preparation, the encoders, the fold plan and its sync, each fold
  instance's forward and backward by resolution, the decoder, the
  backward passes and the Adam updates; with a content loss the VGG19
  prefix and the nearest-neighbour loss, forward and backward) with the
  device time of the kernels launched inside it, its host time and its
  calls; and the fold and content-loss kernels' launches a step.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..data.synthetic import synthetic_compact_batch
from ..ops.launches import launch_counts
from ..train.engine import GANConfig, create_state, make_train_step
from .profile_serve import (DATASETS, _category, _idle_share, _span_ms,
                            config_for)

ITERS = 5         # timed steps per measurement
WARMUP = 2


def _batches(cfg: GANConfig, rng, count: int):
    """``count`` (disc_fake, disc_real, gen_batch) triples of synthetic
    compact batches, the disc draws stacked for training_ratio."""
    def draw():
        return synthetic_compact_batch(rng, cfg.batch_size, cfg.image_size,
                                       cfg.pose_dim, gen_type=cfg.gen_type,
                                       num_stacks=cfg.num_stacks)

    def stack():
        draws = [draw() for _ in range(cfg.training_ratio)]
        return {k: np.stack([d[k] for d in draws]) for k in draws[0]}

    return [(stack(), stack(), draw()) for _ in range(count)]


def profile(batch: int, smi: str, warp_backend: str = "matmul",
            dataset: str = "fasion", gen_type: str = "baseline",
            content_loss_layer: str = "none") -> None:
    cfg = config_for(dataset, batch, warp_backend, gen_type,
                     content_loss_layer)
    tag = {"batch": batch, "warp_backend": warp_backend, "dataset": dataset,
           "gen_type": gen_type, "content_loss_layer": content_loss_layer,
           "card": smi}
    state = create_state(cfg, seed=0, device="cuda")
    step = make_train_step(cfg, state)
    batches = _batches(cfg, np.random.default_rng(0), 3)
    images = batch * (2 * cfg.training_ratio + 1)

    for i in range(WARMUP):
        step(*batches[i % len(batches)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spans = []
    t0 = time.perf_counter()
    for i in range(ITERS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        step(*batches[i % len(batches)])
        e.record()
        spans.append((s, e))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    dev_ms = sum(s.elapsed_time(e) for s, e in spans) / ITERS
    print(json.dumps({
        "phase": "train_step", **tag, "dtype": "bfloat16",
        "images_per_step": images, "device_ms": dev_ms,
        "wall_ms": wall_ms, "train_img_per_s": images / wall_ms * 1e3,
        "train_img_per_s_device": images / dev_ms * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}),
        flush=True)

    launches0 = launch_counts()
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for i in range(2):
            step(*batches[i])
        torch.cuda.synchronize()
    launches = {k: (v - launches0[k]) / 2
                for k, v in launch_counts().items()}
    by_cat: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        # device-side events only: the CPU ops' entries repeat the device
        # time of the kernels they launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        kernels.append((dev_us, ev.key, ev.count))
        cat = _category(ev.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + dev_us / 1e3 / 2
    kernels.sort(reverse=True)
    print(json.dumps({
        "phase": "train_profile", **tag, "steps": 2,
        "device_ms_per_step_by_category": by_cat, **_idle_share(prof),
        "top_kernels": [{"name": k[:90], "ms_per_step": us / 1e3 / 2,
                         "calls_per_step": c / 2}
                        for us, k, c in kernels[:15]]}), flush=True)
    print(json.dumps({"phase": "train_layers", **tag,
                      "kernel_launches_per_step": launches,
                      "spans_per_step": _span_ms(prof, 2)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--warp_backend", choices=("matmul", "pallas"),
                    default="matmul")
    ap.add_argument("--dataset", choices=sorted(DATASETS), default="fasion")
    ap.add_argument("--gen_type", choices=("baseline", "stacked", "unet"),
                    default="baseline")
    ap.add_argument("--content_loss_layer", default="none",
                    help="a VGG19 layer (block1_conv2): the full_fasion "
                         "recipe; none = L1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    for batch in args.batch:
        profile(batch, smi, args.warp_backend, args.dataset, args.gen_type,
                args.content_loss_layer)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
