"""Where a training step spends its device time.

    python3 -m pose_transfer_torch.tools.profile_train [--batch 8 32]
        [--warp_backend {matmul,pallas}] [--dataset {fasion,h36m}]

For each batch size, builds the full-width training state of the dataset
(``fasion``: 256², pose_dim 18; ``h36m``: 224², pose_dim 16, the 6-stage
ladder; generator and discriminator, bf16, seeded random weights,
``create_state``; ``--warp_backend pallas`` puts the fold stages the fused
warp fold takes on it) and the two-phase step (``make_train_step``), and
reports as JSON lines, each naming the backend and dataset:
- the step: device ms (CUDA events around each step, mean over 5 steps after
  2 warm-up steps), host wall ms, train img/s from the wall time and from
  the device time, and peak device memory. Images per step are counted as
  N·(2·training_ratio + 1), the generator forwards' inputs, as the JAX
  package's bench counts them;
- the device time by layer (CUDA events around each, taken in separate
  steps): batch preparation, the discriminator phase's generator forward
  and each of its fold instances, the discriminator forward, backward and
  Adam update, the generator phase's forward and its fold instances, the
  discriminator forward in the generator phase, the generator backward with
  each fold instance's backward (the fold_route launch and the transposed
  warps, or the warp_fold_bwd launch) split out, and the generator's Adam
  update;
- a ``torch.profiler`` trace of two steps: device time by kernel category
  (``profile_serve._category``), the device's idle share within the traced
  span (``profile_serve._idle_share``) and the top kernels.
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
from ..models import networks
from ..ops import warp as warp_mod
from ..ops import warp_fused, warp_pallas
from ..train.engine import GANConfig, create_state, make_train_step
from .profile_serve import DATASETS, _category, _idle_share, config_for

ITERS = 5         # timed steps per measurement
WARMUP = 2


def _batches(cfg: GANConfig, rng, count: int):
    """``count`` (disc_fake, disc_real, gen_batch) triples of synthetic
    compact batches, the disc draws stacked for training_ratio."""
    def draw():
        return synthetic_compact_batch(rng, cfg.batch_size, cfg.image_size,
                                       cfg.pose_dim)

    def stack():
        draws = [draw() for _ in range(cfg.training_ratio)]
        return {k: np.stack([d[k] for d in draws]) for k in draws[0]}

    return [(stack(), stack(), draw()) for _ in range(count)]


def _layer_ms(step, batches) -> dict:
    """Mean device ms per step of each layer, from CUDA events recorded
    around it; the wrappers are installed for this measurement only."""
    st = step.state
    marks = []
    phase = ["?"]

    def timed(label_of, fn):
        def wrapper(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            marks.append((label_of(a), s, e))
            return out
        return wrapper

    def in_phase(name):
        return lambda a: f"{name} ({phase[0]})"

    def set_phase(name, fn):
        def wrapper(*a, **k):
            phase[0] = name
            return fn(*a, **k)
        return wrapper

    def res(a):
        return f"{a[0].shape[1]}x{a[0].shape[2]}"

    saved_mod = {
        (networks, "affine_transform_layer"): networks.affine_transform_layer,
        (warp_mod, "_fold_windowed_place_bwd"):
            warp_mod._fold_windowed_place_bwd,
        (warp_mod, "_fold_scan_bwd"): warp_mod._fold_scan_bwd,
        (warp_fused, "fold_route"): warp_fused.fold_route,
        (warp_pallas, "warp_fold_bwd"): warp_pallas.warp_fold_bwd,
        (torch.Tensor, "backward"): torch.Tensor.backward,
    }
    networks.affine_transform_layer = timed(
        lambda a: f"fold_fwd_{res(a)} ({phase[0]})",
        saved_mod[(networks, "affine_transform_layer")])
    warp_mod._fold_windowed_place_bwd = timed(
        lambda a: f"fold_bwd_{res(a)} (gen phase)",
        saved_mod[(warp_mod, "_fold_windowed_place_bwd")])
    warp_mod._fold_scan_bwd = timed(
        lambda a: f"fold_bwd_{res(a)} (gen phase)",
        saved_mod[(warp_mod, "_fold_scan_bwd")])
    warp_fused.fold_route = timed(
        lambda a: f"fold_route_{res(a)} (gen phase)",
        saved_mod[(warp_fused, "fold_route")])
    warp_pallas.warp_fold_bwd = timed(
        lambda a: f"fold_bwd_{res(a)} (gen phase)",
        saved_mod[(warp_pallas, "warp_fold_bwd")])
    torch.Tensor.backward = timed(in_phase("backward"),
                                  saved_mod[(torch.Tensor, "backward")])
    inst = {(step, "disc_phase"): set_phase("disc phase", step.disc_phase),
            (step, "gen_phase"): set_phase("gen phase", step.gen_phase)}
    inst[(step, "prepare")] = timed(in_phase("prepare"), step.prepare)
    inst[(st.gen, "forward")] = timed(in_phase("gen_forward"),
                                      st.gen.forward)
    inst[(st.disc, "forward")] = timed(in_phase("disc_forward"),
                                       st.disc.forward)
    inst[(st.gen_opt, "step")] = timed(lambda a: "adam (gen phase)",
                                       st.gen_opt.step)
    inst[(st.disc_opt, "step")] = timed(lambda a: "adam (disc phase)",
                                        st.disc_opt.step)
    # instance attributes to restore (step.prepare); the rest are methods
    # of the class, uncovered again by deleting the instance's wrapper
    own = {key: key[0].__dict__.get(key[1]) for key in inst}
    for (obj, name), fn in inst.items():
        setattr(obj, name, fn)
    try:
        for b in batches:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            step(*b)
            e.record()
            marks.append(("step", s, e))
    finally:
        for (obj, name), fn in saved_mod.items():
            setattr(obj, name, fn)
        for (obj, name), fn in own.items():
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)
    torch.cuda.synchronize()
    out: dict[str, float] = {}
    for label, s, e in marks:
        out[label] = out.get(label, 0.0) + s.elapsed_time(e) / len(batches)
    fold_bwd = sum(v for k, v in out.items() if k.startswith("fold_bwd_"))
    out["gen backward other than the fold (gen phase)"] = \
        out.get("backward (gen phase)", 0.0) - fold_bwd
    return dict(sorted(out.items()))


def profile(batch: int, smi: str, warp_backend: str = "matmul",
            dataset: str = "fasion") -> None:
    cfg = config_for(dataset, batch, warp_backend)
    tag = {"batch": batch, "warp_backend": warp_backend, "dataset": dataset,
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

    def counts():
        return {**warp_fused.LAUNCHES, **warp_pallas.LAUNCHES}
    launches0 = counts()
    layers = _layer_ms(step, [batches[i % len(batches)]
                              for i in range(ITERS)])
    launches = {k: (v - launches0[k]) / ITERS for k, v in counts().items()}
    print(json.dumps({"phase": "train_layers", **tag,
                      "kernel_launches_per_step": launches,
                      "device_ms_per_step": layers}), flush=True)

    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for i in range(2):
            step(*batches[i])
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
        by_cat[cat] = by_cat.get(cat, 0.0) + dev_us / 1e3 / 2
    kernels.sort(reverse=True)
    print(json.dumps({
        "phase": "train_profile", **tag, "steps": 2,
        "device_ms_per_step_by_category": by_cat, **_idle_share(prof),
        "top_kernels": [{"name": k[:90], "ms_per_step": us / 1e3 / 2,
                         "calls_per_step": c / 2}
                        for us, k, c in kernels[:15]]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--warp_backend", choices=("matmul", "pallas"),
                    default="matmul")
    ap.add_argument("--dataset", choices=sorted(DATASETS), default="fasion")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    for batch in args.batch:
        profile(batch, smi, args.warp_backend, args.dataset)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
