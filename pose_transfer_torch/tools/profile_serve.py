"""Where a serving forward spends its device time, and how the server
holds up under a stream of requests.

    python3 -m pose_transfer_torch.tools.profile_serve [--batch 8]
        [--warp_backend {matmul,pallas}] [--dataset {fasion,h36m}]
        [--gen_type {baseline,stacked,unet}]

Builds the full-width generator of the dataset (``fasion``: 256², pose_dim
18, the 7-stage ladder; ``h36m``: 224², pose_dim 16, the 6-stage ladder;
bf16, seeded random weights; ``--warp_backend pallas`` puts the fold
stages the fused warp fold takes on it: 256² and 128² for fasion, none for
h36m; ``--gen_type`` the deformable generator, the stacked one of 4
stages or the plain U-Net) and reports as JSON lines, each naming the
backend, dataset and generator type:
- the device time of one eval step on one prepared batch of synthetic
  requests (CUDA events, mean over 10 steps after warm-up) and its host
  wall time;
- a ``torch.profiler`` trace of three steps: device time summed by kernel
  category (convolution, GEMM — the fold's two-pass einsums —, the
  ``fold_place``, ``fold_route``, ``warp_fold`` and ``warp_fold_bwd``
  kernels, other elementwise/reduction kernels), the device's
  idle share within the traced span, and the top kernels;
- the layers, from the same trace: per step, each of the program's spans
  (``utils.spans``: batch preparation, the encoders, the fold plan and its
  sync, each fold instance by resolution, the decoder; the stacked
  generator's stages add up under one name) with the device time of the
  kernels launched inside it, its host time and its calls;
- ``PoseTransferServer`` (default 5 ms admission window) under load, over
  384 requests cycled from a pool of 64 seeded synthetic ones:
  first all submitted at once (completed img/s: the capacity), then open-loop
  Poisson arrivals at 1/2 and 4/5 of that capacity. Latency runs from a
  request's scheduled arrival to its resolved future, host request
  preparation included; p50/p95/p99, mean batch fill, requests sent,
  answered and failed.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..data.dataset import collate
from ..data.synthetic import random_image, random_skeleton
from ..serve import PoseTransferServer
from ..train.engine import GANConfig, build_models, make_eval_step

ITERS = 10        # timed steps per device measurement
# the name prefixes of the program's spans (utils.spans)
SPANS = ("serve.", "step.", "train.", "gen.", "fold.", "content.")
REQUESTS = 384    # requests per serving load: tails from hundreds, not tens
# --dataset: image size and pose schema as the CLI derives them
DATASETS = {"fasion": ((256, 256), 18), "h36m": ((224, 224), 16)}


def config_for(dataset: str, batch: int, warp_backend: str,
               gen_type: str = "baseline",
               content_loss_layer: str = "none") -> GANConfig:
    """The full-width bf16 configuration of ``dataset`` and ``gen_type``
    (the stacked generator with the JAX default of 4 stages). With a
    ``content_loss_layer`` the reference's full_fasion recipe: nn_loss of
    area 5 over that layer's VGG19 features, weight 1.0."""
    size, pose_dim = DATASETS[dataset]
    recipe = {} if content_loss_layer == "none" else dict(
        content_loss_layer=content_loss_layer, nn_loss_area_size=5,
        l1_penalty_weight=1.0)
    return GANConfig(image_size=size, pose_dim=pose_dim, batch_size=batch,
                     compute_dtype=torch.bfloat16, warp_backend=warp_backend,
                     gen_type=gen_type, **recipe)


def requests(rng, n: int, cfg: GANConfig) -> list:
    """``n`` synthetic (image, kp_from, kp_to) requests for ``cfg``."""
    size = cfg.image_size
    return [(random_image(rng, size),
             random_skeleton(rng, size, cfg.pose_dim).astype(np.float32),
             random_skeleton(rng, size, cfg.pose_dim).astype(np.float32))
            for _ in range(n)]


def _category(name: str) -> str:
    n = name.lower()
    for kernel in ("warp_fold_bwd", "warp_fold", "fold_place_stream"):
        if kernel in n:
            return kernel
    if "fold_place" in n:
        return "fold_place"
    if "fold_route" in n:
        return "fold_route"
    if "conv" in n or "dgrad" in n or "wgrad" in n or "fprop" in n:
        return "conv"
    if "gemm" in n or "xmma" in n or "cutlass" in n or "nvjet" in n:
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "elementwise_reduce"


def _span_ms(prof, steps: int) -> dict:
    """Per step, each of the program's spans in the trace (by name): the
    device time of the kernels launched inside it, its host time and its
    calls."""
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CPU \
                and ev.key.startswith(SPANS):
            out[ev.key] = {"device_ms": ev.device_time_total / 1e3 / steps,
                           "host_ms": ev.cpu_time_total / 1e3 / steps,
                           "calls": ev.count / steps}
    return dict(sorted(out.items()))


def _idle_share(prof) -> dict:
    """Device busy and idle time within the traced span, from the trace
    alone: the union of the device events' intervals (kernels, copies,
    sets) over the span from the first one's start to the last one's end."""
    ivs = sorted((ev.time_range.start, ev.time_range.end)
                 for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
    if not ivs:
        raise RuntimeError("the trace holds no device events")
    busy, cur_s, cur_e = 0.0, ivs[0][0], ivs[0][1]
    for s, e in ivs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in ivs) - ivs[0][0]
    if not 0 < busy <= span:
        raise RuntimeError(f"device busy {busy} us outside span {span} us")
    return {"device_span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / span}


def _serve_load(srv, pool, n: int, rate, rng) -> dict:
    """``n`` requests cycled from ``pool``: all at once when ``rate`` is
    None, else open-loop Poisson arrivals of ``rate`` per second. Latency
    from each request's scheduled arrival to its resolved future."""
    due = np.cumsum(rng.exponential(1.0 / rate, n)) if rate else np.zeros(n)
    done_at = np.full(n, np.nan)

    def mark(i):
        return lambda _f: done_at.__setitem__(i, time.perf_counter())

    srv.reset_stats()
    t0 = time.perf_counter()
    futs = []
    for i in range(n):
        wait = t0 + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        fut = srv.submit(*pool[i % len(pool)])
        fut.add_done_callback(mark(i))
        futs.append(fut)
    failed = 0
    for fut in futs:
        try:
            fut.result(timeout=300)
        except Exception:   # counted: a failed request is reported, not fatal
            failed += 1
    while np.isnan(done_at).any():   # callbacks run just after result()
        time.sleep(1e-3)
    lat_ms = (done_at - (t0 + due)) * 1e3
    stats = srv.stats()
    return {"offered_per_s": rate, "sent": n, "answered": n - failed,
            "failed": failed,
            "img_per_s": (n - failed) / (np.nanmax(done_at) - t0),
            "latency_ms": {f"p{q}": float(np.nanpercentile(lat_ms, q))
                           for q in (50, 95, 99)},
            "mean_batch_fill": stats["mean_batch_fill"],
            "batches": stats["batches"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--warp_backend", choices=("matmul", "pallas"),
                    default="matmul")
    ap.add_argument("--dataset", choices=sorted(DATASETS), default="fasion")
    ap.add_argument("--gen_type", choices=("baseline", "stacked", "unet"),
                    default="baseline")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = config_for(args.dataset, args.batch, args.warp_backend,
                     args.gen_type)
    tag = {"batch": args.batch, "warp_backend": args.warp_backend,
           "dataset": args.dataset, "gen_type": args.gen_type, "card": smi}
    gen = build_models(cfg, seed=0, device="cuda")
    step = make_eval_step(cfg, gen)
    with PoseTransferServer(cfg, gen) as srv:      # its request assembly
        batch = collate([srv.prepare_request(*r) for r in requests(
            np.random.default_rng(0), args.batch, cfg)])

    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(ITERS):
        step(batch)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    dev_ms = start.elapsed_time(end) / ITERS
    print(json.dumps({"phase": "step", **tag, "device_ms": dev_ms,
                      "wall_ms": wall_ms,
                      "img_per_s_device": args.batch / dev_ms * 1e3}),
          flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
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
        by_cat[cat] = by_cat.get(cat, 0.0) + dev_us / 1e3 / 3
    kernels.sort(reverse=True)
    print(json.dumps({
        "phase": "profile", **tag, "steps": 3,
        "device_ms_per_step_by_category": by_cat,
        **_idle_share(prof),
        "top_kernels": [{"name": k[:90], "ms_per_step": us / 1e3 / 3,
                         "calls_per_step": c / 3}
                        for us, k, c in kernels[:15]]}), flush=True)
    print(json.dumps({"phase": "layers", **tag,
                      "spans_per_step": _span_ms(prof, 3)}), flush=True)

    rng = np.random.default_rng(1)
    pool = requests(rng, 64, cfg)
    with PoseTransferServer(cfg, gen) as srv:
        _serve_load(srv, pool, 4 * args.batch, None, rng)     # warm-up
        capacity = _serve_load(srv, pool, REQUESTS, None, rng)
        loads = [capacity] + [
            _serve_load(srv, pool, REQUESTS,
                        frac * capacity["img_per_s"], rng)
            for frac in (0.5, 0.8)]
    for load in loads:
        print(json.dumps({"phase": "serve_load", **tag, **load}),
              flush=True)
        if load["failed"]:
            raise RuntimeError(f"{load['failed']} requests failed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
