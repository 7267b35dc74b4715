#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):
  1. device   card name, and name + power limit as nvidia-smi reports them
  2. build    compile every kernel of pose_transfer_torch/csrc with nvcc
  3. kernels  each kernel against its plain PyTorch version at the shapes
              the serving path gives it (bitwise), with its time, the plain
              version's time and the memory-bound least time
  4. serve    the full-width fashion-256 deformable generator (bf16, seeded
              random weights) behind PoseTransferServer: two full batches
              of 8 and a padded partial batch of 3; outputs checked, fold
              kernel launches counted, the kernel-placed fold held against
              the plain full-scan fold
  5. the kernels line, then the last line {"ok": true, "device": {...}}

Exits non-zero without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from pose_transfer_torch import _build
from pose_transfer_torch.data.dataset import collate
from pose_transfer_torch.data.synthetic import random_image, random_skeleton
from pose_transfer_torch.ops import warp as warp_mod
from pose_transfer_torch.ops import warp_fused
from pose_transfer_torch.serve import PoseTransferServer
from pose_transfer_torch.train.engine import (GANConfig, build_models,
                                              make_eval_step)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
GEN_PARAMS = 82_080_611       # fashion-256 generator (reference logs)
# fashion-256 fold stages that take the windowed fold:
# (H = W, C, SY, SX) for skips 256²×64, 128²×128, 64²×256; P = 9 parts
STAGES = ((256, 64, 128, 144), (128, 128, 64, 80), (64, 256, 32, 48))
BATCH, PARTS = 8, 9
# bf16 serving: the kernel-placed and the full-scan fold compute the same
# taps and the same roundings, so the outputs agree unless cuBLAS sums an
# einsum in another order and flips a bf16 rounding in a skip (≤ 2^-8
# relative), which the decoder then carries: max 0.05, mean 1e-3 on the
# tanh output. In f32 (TF32 off) the same comparison holds max 1e-4.
BF16_MAX_ABS, BF16_MEAN_ABS, F32_MAX_ABS = 0.05, 1e-3, 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_cuda(fn, iters: int, flush: torch.Tensor | None = None) -> float:
    """Mean ms per call, CUDA events around each call after a warm-up;
    ``flush`` (a buffer larger than L2) is overwritten before every call,
    outside the timed span, so inputs start cold as in the serving path."""
    for _ in range(2):
        fn()
    spans = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / iters


def place_inputs(h, c, sy, sx, dtype, gen):
    """fold_place inputs: negatives in the body, zeros and fractions in the
    mask windows, x0 ≡ 0 mod 16, exact ties (part 2 repeats part 1)."""
    dev = "cuda"
    n, p, w = BATCH, PARTS, h
    body = torch.randn((n, h, w, c), generator=gen, device=dev).to(dtype)
    wins = torch.randn((n, p, sy, sx, c), generator=gen, device=dev)
    levels = torch.tensor([0.0, 0.25, 0.5, 1.0], device=dev)
    mwins = levels[torch.randint(0, 4, (n, p, sy, sx), generator=gen,
                                 device=dev)]
    y0 = torch.randint(0, h - sy + 1, (n, p), generator=gen, device=dev)
    x0 = 16 * torch.randint(0, (w - sx) // 16 + 1, (n, p), generator=gen,
                            device=dev)
    y0[:, 1], x0[:, 1] = y0[:, 0], x0[:, 0]
    wins[:, 1], mwins[:, 1] = wins[:, 0], mwins[:, 0]
    parts = torch.arange(1, p + 1, device=dev).expand(n, p)
    offs = torch.stack([y0, x0, parts], -1).to(torch.int32).contiguous()
    zero_nb = torch.rand((n, h, w), generator=gen, device=dev) < 0.5
    return (body.contiguous(), wins.to(dtype).contiguous(),
            mwins.to(dtype).contiguous(), zero_nb, offs)


def place_bytes(h, c, sy, sx, itemsize, emit_idx) -> int:
    n, p = BATCH, PARTS
    b = itemsize * (2 * n * h * h * c + n * p * sy * sx * c + n * p * sy * sx)
    b += n * h * h + n * p * 3 * 4                  # zero_nb, offs
    return b + (n * h * h * c if emit_idx else 0)    # int8 idx


def phase_kernels(flush) -> dict:
    """fold_place against fold_place_reference at the serving shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    main = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
            "ops_ms": 0.0}
    max_err = 0.0
    for dtype, bits in ((torch.bfloat16, torch.int16),
                        (torch.float32, torch.int32)):
        for emit_idx in (False, True):
            for h, c, sy, sx in STAGES:
                args = place_inputs(h, c, sy, sx, dtype, gen)
                ref, ref_idx = warp_fused.fold_place_reference(
                    *args, emit_idx=emit_idx)
                out, idx = warp_fused.fold_place(*args, emit_idx=emit_idx)
                torch.cuda.synchronize()
                same = torch.equal(out.view(bits), ref.view(bits))
                if emit_idx:
                    same = same and torch.equal(idx, ref_idx)
                err = (out.float() - ref.float()).abs().max().item()
                max_err = max(max_err, err)
                check(same, f"fold_place bitwise {dtype} emit_idx={emit_idx} "
                      f"at {h}x{h}x{c}")
                ms = time_cuda(lambda: warp_fused.fold_place(
                    *args, emit_idx=emit_idx), 20, flush)
                plain_ms = time_cuda(lambda: warp_fused.fold_place_reference(
                    *args, emit_idx=emit_idx), 3, flush)
                nbytes = place_bytes(h, c, sy, sx, out.element_size(),
                                     emit_idx)
                # the least time for the bytes, and for the operations:
                # one multiply and one compare per window element
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = 2 * BATCH * PARTS * sy * sx * c / F32_OPS_PER_S * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                emit({"phase": "kernel", "name": "fold_place",
                      "dtype": str(dtype).split(".")[-1],
                      "emit_idx": emit_idx,
                      "shape": {"N": BATCH, "H": h, "W": h, "C": c,
                                "P": PARTS, "SY": sy, "SX": sx},
                      "bitwise_equal": same, "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
                      "bound_ms": bound_ms, "ops_ms": ops_ms,
                      "bound_by": "bytes" if bytes_ms >= ops_ms
                      else "operations"})
                if dtype == torch.bfloat16 and not emit_idx:
                    # the serving variant: summed over one forward's stages
                    main["ms"] += ms
                    main["plain_ms"] += plain_ms
                    main["bound_ms"] += bound_ms
                    main["bytes_ms"] += bytes_ms
                    main["ops_ms"] += ops_ms
    main["max_abs_err"] = max_err
    return main


def make_requests(rng, n, size):
    return [(random_image(rng, size),
             random_skeleton(rng, size, 18).astype(np.float32),
             random_skeleton(rng, size, 18).astype(np.float32))
            for _ in range(n)]


def check_images(out, n, what):
    check(out.shape == (n, 256, 256, 3), f"{what} shape {out.shape}")
    check(bool(np.isfinite(out).all()), f"{what} finite")
    check(bool((np.abs(out) <= 1.0).all()), f"{what} in [-1, 1]")


def phase_serve(card: str) -> int:
    cfg = GANConfig(image_size=(256, 256), pose_dim=18, batch_size=BATCH,
                    compute_dtype=torch.bfloat16)
    gen = build_models(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in gen.parameters())
    check(n_params == GEN_PARAMS, f"generator has {n_params} parameters")
    check(gen.warp_windowed, "auto rule turns the windowed fold on on CUDA")
    reqs = make_requests(np.random.default_rng(0), 2 * BATCH + 3, (256, 256))
    warm = make_requests(np.random.default_rng(1), BATCH, (256, 256))

    torch.cuda.reset_peak_memory_stats()
    with PoseTransferServer(cfg, gen, max_wait_ms=200.0) as srv:
        check_images(srv.generate(warm), BATCH, "warm-up")
        srv.reset_stats()
        warp_fused.LAUNCHES["fold_place"] = 0
        warp_mod.COUNTS["scan_fallback"] = 0
        full = srv.generate(reqs[:2 * BATCH])
        stats = srv.stats()
        partial = srv.generate(reqs[2 * BATCH:])
        launches = warp_fused.LAUNCHES["fold_place"]
        fallbacks = warp_mod.COUNTS["scan_fallback"]
        batch = collate([srv.prepare_request(*r) for r in reqs[:BATCH]])
    check_images(full, 2 * BATCH, "full batches")
    check_images(partial, 3, "partial batch")
    forwards = stats["batches"] + 1
    check(launches + fallbacks == 3 * forwards,
          f"{launches} launches + {fallbacks} fallbacks != 3 per forward")
    check(launches > 0, "serving launched no fold_place kernel")
    emit({"phase": "serve", "requests": 2 * BATCH + 3, "forwards": forwards,
          "fold_place_launches": launches, "scan_fallbacks": fallbacks,
          "launches_per_forward": launches / forwards,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    # one burst of 16 requests: a check that the server answers, not a
    # serving benchmark (tools/profile_serve.py measures under load)
    emit({"phase": "serve_smoke_stats", "batch": BATCH, "dtype": "bfloat16",
          "card": card, **stats})

    # one full batch through the kernel-placed fold and the plain
    # full-scan fold, same weights, same inputs
    for dtype in (torch.bfloat16, torch.float32):
        gen.dtype = dtype
        step = make_eval_step(dataclasses.replace(cfg, compute_dtype=dtype),
                              gen)
        warp_fused.LAUNCHES["fold_place"] = 0
        warp_mod.COUNTS["scan_fallback"] = 0
        gen.warp_windowed = True
        out_k, _ = step(batch)
        launches_one = warp_fused.LAUNCHES["fold_place"]
        fallbacks_one = warp_mod.COUNTS["scan_fallback"]
        gen.warp_windowed = False
        out_p, _ = step(batch)
        gen.warp_windowed = True
        diff = (out_k.float() - out_p.float()).abs()
        res = {"phase": "kernel_vs_plain_fold",
               "dtype": str(dtype).split(".")[-1],
               "launches": launches_one, "scan_fallbacks": fallbacks_one,
               "max_abs_diff": diff.max().item(),
               "mean_abs_diff": diff.mean().item()}
        emit(res)
        check(launches_one == 3, f"{launches_one} launches in one forward")
        if dtype == torch.bfloat16:
            check(res["max_abs_diff"] <= BF16_MAX_ABS
                  and res["mean_abs_diff"] <= BF16_MEAN_ABS,
                  "bf16 kernel fold vs plain fold")
        else:
            check(res["max_abs_diff"] <= F32_MAX_ABS,
                  "f32 kernel fold vs plain fold")
    gen.dtype = torch.bfloat16
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # f32 comparisons on the card run in full f32: no TF32 in matmuls or
    # convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    reports = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in reports.items()}})

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    main_place = phase_kernels(flush)
    del flush
    launches = phase_serve(smi)

    emit({"kernels": [{
        "name": "fold_place", "route": "cuda",
        "source": "pose_transfer_torch/csrc/fold_place.cu",
        "replaces": "pose_transfer_tpu/ops/warp_fused.py:189",
        "launches": launches, "max_abs_err": main_place["max_abs_err"],
        "ms": main_place["ms"], "plain_ms": main_place["plain_ms"],
        "bound_ms": main_place["bound_ms"],
        "bound_by": "bytes" if main_place["bytes_ms"] >= main_place["ops_ms"]
        else "operations",
        "library_ms": None, "checked_vs_plain": True}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
