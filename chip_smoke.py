#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--baseline DIR] [--ablate]

Phases (each prints JSON lines; any failure raises and exits non-zero):
  1. device   card name, and name + power limit as nvidia-smi reports them
  2. build    compile every kernel of pose_transfer_torch/csrc with nvcc
  3. kernels  each kernel against its plain PyTorch version at the shapes
              the serving and training paths give it (bitwise; the fused
              fold's forward warp_fold bitwise but for the sign of zeros,
              its backward warp_fold_bwd within a stated tolerance), with
              its time, the plain version's time and the least time for
              its bytes and operations; the fused fold's two kernels on
              two input sets (random affines and masks, and a training
              step's own transforms and masks), with the share of (tile,
              part) pairs they counted as skipped; with --baseline DIR
              also another checkout's two kernels, timed in turns with
              these; with --ablate on ablated inputs too; fold_place_stream
              over 9 parts in groups of 3 at the windowed stages
  4. serve    the full-width fashion-256 deformable generator (bf16, seeded
              random weights) behind PoseTransferServer: two full batches
              of 8 and a padded partial batch of 3; outputs checked, fold
              kernel launches counted, the kernel-placed fold held against
              the plain full-scan fold
  5. train    the two-phase GAN step at full width (generator and
              discriminator, bf16, batch 8, seeded): one warm-up step and 3
              steps on synthetic batches; losses finite, both nets' weights
              moved, fold_place and fold_route launches counted; then the
              fold's gradient through the kernels (fold_place with the
              argmax, fold_route) held against autograd through the plain
              full-scan fold, in f32
  6. pallas   warp_backend='pallas': the same serving and training paths
              with the 256² and 128² fold stages on the fused two-pass warp
              fold (warp_fold, and warp_fold_bwd in the backward; the 64²
              stage falls back to fold_place/fold_route): launches counted
              per forward and per step, the generator held against the
              matmul backend, the fused fold's f32 gradient held against
              autograd through the plain full scan
  7. stream   the fold microbenchmark's path (pose_transfer_torch.tools
              .bench_fold) at full width, fashion-256 stage 0 (256²×64,
              N = 32, bf16, synthetic transforms and masks): the part-group
              stream through fold_place_stream (3 and 9 groups, with and
              without the argmax) bitwise against fold_place on one wins
              stack; the tool's partstream experiment (ms, peak memory,
              launches counted); its 'xla' and 'kernel' placements at N = 8,
              forward and feature gradient, held to each other in bf16 and
              f32
  8. cli_h36m the port's command-line entry points in this process at full width
              on h36m (224², pose_dim 16, the 6-stage ladder, bf16, batch
              8): make_synthetic_data writes a PNG dataset (4 people x 6
              frames: 16 frame pairs a split, so that batches of 8 can be
              drawn; 3 frames a person give 4), cli.main trains 2 epochs of
              3 iterations (losses finite, checkpoints, grids, fold_place
              and fold_route launches counted, the seconds each background
              save held the loop), cli.main --resume 1 runs into a third
              epoch (resumes at epoch 2, seeks the stream by 9 batches),
              cli.test writes a grid per test batch, cli.evaluate prints
              finite metrics; then the h36m 224² fold through the kernels
              against the plain full scan (forward and feature gradient,
              bf16 and f32), and the 'pallas' backend's h36m forward, which
              launches no warp_fold and equals the 'matmul' one
  9. the kernels line (warp_fold and warp_fold_bwd: ms and bounds on the
     random set, as since their first port; ms_main, plain_ms_main and
     bound_ms_main on a training step's own inputs), then the last line
     {"ok": true, "device": {...}}

Exits non-zero without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from pose_transfer_torch import _build
from pose_transfer_torch.cli import evaluate as cli_evaluate
from pose_transfer_torch.cli import main as cli_main
from pose_transfer_torch.cli import make_synthetic_data as cli_data
from pose_transfer_torch.cli import test as cli_test
from pose_transfer_torch.core.transforms_host import static_empty_parts
from pose_transfer_torch.data.loader import BatchStream
from pose_transfer_torch.data.dataset import collate
from pose_transfer_torch.data.device import make_batch_preparer
from pose_transfer_torch.data.synthetic import random_image, random_skeleton
from pose_transfer_torch.ops import warp as warp_mod
from pose_transfer_torch.ops import warp_fused
from pose_transfer_torch.ops import warp_pallas
from pose_transfer_torch.serve import PoseTransferServer
from pose_transfer_torch.data.synthetic import synthetic_compact_batch
from pose_transfer_torch.tools import bench_fold
from pose_transfer_torch.train import checkpoint
from pose_transfer_torch.train.engine import (GANConfig, build_models,
                                              create_state, make_eval_step,
                                              make_train_step)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
GEN_PARAMS = 82_080_611       # fashion-256 generator (reference logs)
DISC_PARAMS = 2_803_782       # fashion discriminator (reference logs)
TRAIN_STEPS = 3
# fashion-256 fold stages that take the windowed fold:
# (H = W, C, SY, SX) for skips 256²×64, 128²×128, 64²×256; P = 9 parts
STAGES = ((256, 64, 128, 144), (128, 128, 64, 80), (64, 256, 32, 48))
BATCH, PARTS = 8, 9
STREAM_PG = 3                 # parts per fold_place_stream group (phase 3)
# phase 7: the fold microbenchmark at fashion-256 stage 0
STREAM_BATCH, STREAM_GROUPS = 32, (3, 9)
BENCH_ITERS, BENCH_WARMUP = 3, 1
# bf16 serving: the kernel-placed and the full-scan fold compute the same
# taps and the same roundings, so the outputs agree unless cuBLAS sums an
# einsum in another order and flips a bf16 rounding in a skip (≤ 2^-8
# relative), which the decoder then carries: max 0.05, mean 1e-3 on the
# tanh output. In f32 (TF32 off) the same comparison holds max 1e-4. The
# 'pallas' generator against the 'matmul' one is held to the same limits:
# its fold rounds the masked warp once where the matmul branch rounds the
# warp and then the product, and its positions in another order, so more
# single-ulp flips enter the skips (measured bf16 max 5.9e-3, mean 1.3e-5;
# f32 1.5e-5).
BF16_MAX_ABS, BF16_MEAN_ABS, F32_MAX_ABS = 0.05, 1e-3, 1e-4
# f32 fold gradient, kernels against autograd through the plain full scan:
# the same taps, summed in another order (the joint transposed contraction
# sums parts and window rows in one GEMM; autograd part by part), ~1e-7
# relative. Where two parts' warped values tie to within an ulp, the two
# folds' f32 sums may crown different winners and route that pixel's
# cotangent to different parts; such near-ties are rare, so all but
# GRAD_FLIP_SHARE of the gradient's elements must agree within
# GRAD_REL_TOL of its largest magnitude.
GRAD_REL_TOL, GRAD_FLIP_SHARE = 1e-5, 1e-5
# The fused fold against the full scan: the two compute their positions in
# other orders (the fused fold as the TPU kernel does, ops/warp_pallas.py),
# so a weight differs by up to an ulp of its position (1.5e-5 at positions
# up to 256) and the gradients by up to ~2e-5 of the largest, not by one
# GEMM's summation order; and more near-ties crown another part. Measured
# on the CPU at a real batch's transforms (N = 2, C = 8 at 256²): 14 of
# 1 048 576 elements beyond 3e-5 of the largest (75 beyond 1e-5), 12 of
# them flips. Against autograd through the plain fused fold the same
# gradient agreed within 5e-8 of the largest (tests/test_torch_warp_pallas
# .py holds the plain backward to that autograd).
PALLAS_GRAD_REL_TOL, PALLAS_GRAD_FLIP_SHARE = 3e-5, 1e-4
# the fused warp fold's stages (H = W, C) at N = 8, T = 10 parts
PALLAS_STAGES = ((256, 64), (128, 128))
PALLAS_PARTS = 10
# warp_fold against its plain version: bitwise, but for the sign of zeros.
# The kernel skips a part's taps where its mask is 0 and folds +0 there; the
# plain version rounds z·0 to z's signed zero. The fold compares with a
# strict f32 '>', and +0 == −0, so the argmax cannot differ: out is compared
# with −0 mapped to +0 (``fwd_same``), idx bitwise.
# warp_fold_bwd against its plain version: both sum exact products in f64,
# in other orders, so a rounding to f32 (dtmp, df_t) or to bf16 may flip
# where the f64 sums straddle its boundary. f32: within 1e-6 of the
# largest element (a flipped f32 rounding, carried through at most a few
# weights ≤ 1 and 10 parts, is ~1e-7 of it); bf16: every element within
# two bf16 ulps of its own magnitude (one flipped rounding of dtmp or df_t,
# then the in-dtype accumulation).
BWD_F32_REL, BWD_BF16_ULPS = 1e-6, 2
# phase 8: h36m through the CLI (the stage ladder 224², 112², 56², 28², ...)
H36M, H36M_POSE = (224, 224), 16
CLI_ITERS, CLI_FRAMES = 3, 6
# The bf16 fold gradient at h36m's 224² stage against autograd through the
# plain full scan, also in bf16: autograd rounds each part's pass-1
# transpose to bf16 and adds the body's and the 5 active parts' gradients
# one bf16 rounding at a time (6 roundings of half an ulp of a partial sum
# up to the largest magnitude), where the kernel path sums the parts in f32
# and rounds once; so every element is held within H36M_BF16_GRAD_ULPS bf16
# ulps of the largest magnitude (an ulp of its binade: 2^(e-7) for a
# largest of 2^e to 2^(e+1)). Measured: 1 such ulp with the plain placement
# on the CPU (N = 2, C = 64), 2.16 on an H100 (N = 8: 0.2705 at a largest
# of 18.875), while 6 399 of 6.4 M elements lie beyond 2 ulps of their own
# magnitude on the CPU, so that per-element bound does not apply here.
H36M_BF16_GRAD_ULPS = 4


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


def route_inputs(h, c, sy, sx, dtype, gen):
    """fold_route inputs: g with negatives, the mask windows and offsets of
    ``place_inputs`` (zeros among the mask values: signed zeros; two parts
    sharing a window), idx drawn from -1 (zero pass), 0 (body) and the
    parts, a body mask with zeros."""
    g, _, mwins, _, offs = place_inputs(h, c, sy, sx, dtype, gen)
    idx = torch.randint(-1, PARTS + 1, g.shape, generator=gen,
                        device="cuda").to(torch.int8)
    levels = torch.tensor([0.0, 0.5, 1.0], device="cuda")
    mask0 = levels[torch.randint(0, 3, (BATCH, h, h), generator=gen,
                                 device="cuda")].to(dtype)
    return g, idx, mask0, mwins, offs


def route_bytes(h, c, sy, sx, itemsize) -> int:
    """Least bytes of one fold_route: g read and gbody written, gwins
    written, the mask windows and the body mask read once; int8 idx; offs."""
    n, p = BATCH, PARTS
    return itemsize * (2 * n * h * h * c + n * p * sy * sx * c
                       + n * p * sy * sx + n * h * h) \
        + n * h * h * c + 12 * n * p


def stream_bytes(offs, h, c, sy, sx, itemsize, with_idx) -> int:
    """Least bytes of one fold_place_stream launch: the group's wins and
    mask windows read once, offs, and the state (acc, and the int8 idx)
    read and written once over the pixels the group's windows cover,
    counted from ``offs`` on the host (overlaps once)."""
    n, pg = offs.shape[:2]
    cover = np.zeros((n, h, h), bool)
    for i, rows in enumerate(offs.tolist()):
        for y0, x0, _ in rows:
            cover[i, y0:y0 + sy, x0:x0 + sx] = True
    state = 2 * int(cover.sum()) * c * (itemsize + (1 if with_idx else 0))
    return itemsize * n * pg * sy * sx * (c + 1) + 12 * n * pg + state


def _bound(nbytes: int, ops: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _summary() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
            "ops_ms": 0.0, "max_abs_err": 0.0}


def _add(main: dict, res: dict) -> None:
    for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
        main[k] += res[k]


def phase_kernels(flush) -> dict:
    """Each kernel against its plain version at the main path's shapes,
    bitwise; the summaries sum one step's variant over the 3 stages
    (fold_place: bf16 without the argmax, as serving runs it; fold_route:
    bf16; fold_place_stream: a bf16 launch of 3 parts without the argmax,
    as the partstream experiment runs it)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    main = {"fold_place": _summary(), "fold_route": _summary(),
            "fold_place_stream": _summary()}
    for dtype, bits in ((torch.bfloat16, torch.int16),
                        (torch.float32, torch.int32)):
        dname = str(dtype).split(".")[-1]
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
                check(same, f"fold_place bitwise {dtype} emit_idx={emit_idx} "
                      f"at {h}x{h}x{c}")
                ms = time_cuda(lambda: warp_fused.fold_place(
                    *args, emit_idx=emit_idx), 20, flush)
                plain_ms = time_cuda(lambda: warp_fused.fold_place_reference(
                    *args, emit_idx=emit_idx), 3, flush)
                # operations: one multiply and one compare per window element
                res = {"ms": ms, "plain_ms": plain_ms, **_bound(
                    place_bytes(h, c, sy, sx, out.element_size(), emit_idx),
                    2 * BATCH * PARTS * sy * sx * c)}
                emit({"phase": "kernel", "name": "fold_place", "dtype": dname,
                      "emit_idx": emit_idx,
                      "shape": {"N": BATCH, "H": h, "W": h, "C": c,
                                "P": PARTS, "SY": sy, "SX": sx},
                      "bitwise_equal": same, "max_abs_err": err, **res})
                m = main["fold_place"]
                m["max_abs_err"] = max(m["max_abs_err"], err)
                if dtype == torch.bfloat16 and not emit_idx:
                    _add(m, res)
        for h, c, sy, sx in STAGES:
            args = route_inputs(h, c, sy, sx, dtype, gen)
            ref = warp_fused.fold_route_reference(*args)
            out = warp_fused.fold_route(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(o.view(bits), r.view(bits))
                       for o, r in zip(out, ref))
            err = max((o.float() - r.float()).abs().max().item()
                      for o, r in zip(out, ref))
            check(same, f"fold_route bitwise {dtype} at {h}x{h}x{c}")
            ms = time_cuda(lambda: warp_fused.fold_route(*args), 20, flush)
            plain_ms = time_cuda(
                lambda: warp_fused.fold_route_reference(*args), 3, flush)
            # operations: one compare and one multiply per output element
            res = {"ms": ms, "plain_ms": plain_ms, **_bound(
                route_bytes(h, c, sy, sx, out[0].element_size()),
                2 * BATCH * (PARTS * sy * sx + h * h) * c)}
            emit({"phase": "kernel", "name": "fold_route", "dtype": dname,
                  "shape": {"N": BATCH, "H": h, "W": h, "C": c, "P": PARTS,
                            "SY": sy, "SX": sx},
                  "bitwise_equal": same, "max_abs_err": err, **res})
            m = main["fold_route"]
            m["max_abs_err"] = max(m["max_abs_err"], err)
            if dtype == torch.bfloat16:
                _add(m, res)
        for with_idx in (False, True):
            for h, c, sy, sx in STAGES:
                res, err = _check_stream(h, c, sy, sx, dtype, bits, with_idx,
                                         gen, flush)
                m = main["fold_place_stream"]
                m["max_abs_err"] = max(m["max_abs_err"], err)
                if dtype == torch.bfloat16 and not with_idx:
                    _add(m, res)
    return main


def _check_stream(h, c, sy, sx, dtype, bits, with_idx, gen, flush):
    """fold_place_stream against its plain version over the 9 parts in
    groups of STREAM_PG, from a state with negatives (and a random argmax):
    bitwise; ms, plain ms and bound per launch."""
    body, wins, mwins, _, offs = place_inputs(h, c, sy, sx, dtype, gen)
    idx0 = torch.randint(-1, PARTS + 1, body.shape, generator=gen,
                         device="cuda").to(torch.int8) if with_idx else None
    groups = [tuple(a[:, k:k + STREAM_PG].contiguous()
                    for a in (wins, mwins, offs))
              for k in range(0, PARTS, STREAM_PG)]

    def state():
        return body.clone(), None if idx0 is None else idx0.clone()

    acc, idx = state()
    ref, ref_idx = state()
    for grp in groups:
        warp_fused.fold_place_stream(acc, idx, *grp)
        warp_fused.fold_place_stream_reference(ref, ref_idx, *grp)
    torch.cuda.synchronize()
    same = torch.equal(acc.view(bits), ref.view(bits))
    if with_idx:
        same = same and torch.equal(idx, ref_idx)
    err = (acc.float() - ref.float()).abs().max().item()
    check(same, f"fold_place_stream bitwise {dtype} idx={with_idx} at "
          f"{h}x{h}x{c}")
    # after the first pass the state holds each pixel's max, so repeated
    # passes read and write the same bytes and leave it unchanged
    ms = time_cuda(lambda: [warp_fused.fold_place_stream(acc, idx, *g)
                            for g in groups], 20, flush) / len(groups)
    plain_ms = time_cuda(lambda: [warp_fused.fold_place_stream_reference(
        ref, ref_idx, *g) for g in groups], 3, flush) / len(groups)
    nbytes = sum(stream_bytes(g[2], h, c, sy, sx, acc.element_size(),
                              with_idx) for g in groups) / len(groups)
    # operations: one multiply and one compare per window element
    res = {"ms": ms, "plain_ms": plain_ms,
           **_bound(nbytes, 2 * BATCH * STREAM_PG * sy * sx * c)}
    emit({"phase": "kernel", "name": "fold_place_stream",
          "dtype": str(dtype).split(".")[-1], "idx": with_idx,
          "shape": {"N": BATCH, "H": h, "W": h, "C": c, "Pg": STREAM_PG,
                    "groups": len(groups), "SY": sy, "SX": sx},
          "bitwise_equal": same, "max_abs_err": err, **res})
    return res, err


def warp_inputs(h, c, dtype, gen):
    """warp_fold inputs at N = 8, T = 10 (transforms already at the map's
    scale): negative features; part 0 the identity (single taps), part 1 a
    shear and scale, part 2 the translation-by-1000 sentinel, parts 3-9
    random affines (scale 0.7-1.3, shear ±0.3, shift ±h/8), part 5
    repeating part 4's transform and mask (an exact tie); masks with zeros
    and fractions."""
    dev = "cuda"
    n, t = BATCH, PALLAS_PARTS
    f = torch.randn((n, h, h, c), generator=gen, device=dev).to(dtype)
    warps = torch.zeros((n, t, 8), device=dev)
    warps[..., 0] = warps[..., 4] = 1.0
    warps[:, 1, :6] = torch.tensor([0.9, 0.1, 2.0, -0.1, 1.1, -1.0],
                                   device=dev)
    warps[:, 2, 2] = warps[:, 2, 5] = 1000.0
    r = torch.rand((n, t - 3, 6), generator=gen, device=dev) * 2 - 1
    spread = torch.tensor([0.3, 0.3, h / 8, 0.3, 0.3, h / 8], device=dev)
    warps[:, 3:, :6] = r * spread + torch.tensor([1.0, 0, 0, 0, 1.0, 0],
                                                 device=dev)
    levels = torch.tensor([0.0, 0.25, 0.5, 1.0], device=dev)
    masks = levels[torch.randint(0, 4, (n, t, h, h), generator=gen,
                                 device=dev)]
    warps[:, 5], masks[:, 5] = warps[:, 4], masks[:, 4]
    return f.contiguous(), warps.contiguous(), masks.to(dtype).contiguous()


def main_path_inputs(h, c, dtype, seed=0, device="cuda", batch=BATCH):
    """The fused fold's inputs at one stage as a step builds them: a seeded
    ``synthetic_compact_batch`` (fashion-256, pose_dim 18) through
    ``make_batch_preparer`` in ``dtype`` (the generator's cast of the
    warps), the masks resized to (h, h) as ``plan_folds`` does, features
    N(0, 1) in ``dtype``, then ``ops/warp.py::_pallas_args``."""
    image = (256, 256)
    raw = synthetic_compact_batch(np.random.default_rng(seed), batch, image,
                                  18)
    prep = make_batch_preparer(image_size=image, pose_dim=18, device=device,
                               dtype=dtype)(raw)
    masks_r = warp_mod.resize_bilinear(prep["masks"], (h, h))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    f = torch.randn((batch, h, h, c), generator=gen, device=device).to(dtype)
    return warp_mod._pallas_args(f, prep["warps"], masks_r, image)


ABLATIONS = ("sentinel", "identity", "zero_masks")


def ablated(inputs, kind):
    """``inputs`` with every transform the translation-by-1000 sentinel (no
    taps) or the identity (one tap an axis), or with all-zero masks."""
    f, warps, masks = inputs
    if kind == "zero_masks":
        return f, warps, torch.zeros_like(masks)
    warps = torch.zeros_like(warps)
    warps[..., 0] = warps[..., 4] = 1.0
    if kind == "sentinel":
        warps[..., 2] = warps[..., 5] = 1000.0
    return f, warps.contiguous(), masks


def load_baseline(root):
    """``ops/warp_pallas.py`` of another checkout of this repo at ``root``
    (for example a parent commit unpacked with ``git archive``), imported
    as a package of its own: its wrappers launch its own kernels, built
    from its sources into ``root/pose_transfer_torch/_build/``."""
    name = "baseline_pose_transfer_torch"
    pkg = Path(root).resolve() / "pose_transfer_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops.warp_pallas")


def _taps(pos, n):
    """The two ramp taps of each position along an axis of n: columns
    floor(pos) and floor(pos) + 1 (clamped into [0, n)), each with whether
    it carries a nonzero weight inside the axis."""
    j0 = torch.floor(pos)
    first = (j0 >= 0) & (j0 < n)
    second = (j0 + 1 >= 0) & (j0 + 1 < n) & (pos != j0)
    j0 = j0.long()
    return ((j0.clamp(0, n - 1), first), ((j0 + 1).clamp(0, n - 1), second))


def _reached(taps, shape, live=None):
    """Which columns x of each row (N, O, X[, C]) the x taps reach, from
    the outputs where ``live`` (N, O, XO, C) holds if it is given."""
    hit = torch.zeros(shape, dtype=torch.int32, device=taps[0][0].device)
    for x, ok in taps:
        if live is not None:
            ok = ok[..., None] & live
            x = x[..., None].expand_as(ok)
        hit.scatter_add_(2, x, ok.int())
    return hit > 0


def warp_ops(warps, h, c, idx=None):
    """Least operations of warp_fold (``idx`` None) or warp_fold_bwd on
    this run's transforms and argmax; a multiply-add counts 2. Per part t,
    forward: for each output element 2 per x tap (pass 2), the mask
    multiply and, for t > 0, the compare; for each tmp[o, x] that some
    output of row o taps, 2 per y tap, once (pass 1). Backward: for each
    output element whose cotangent part t won, the mask multiply and 2 per
    x tap (pass 2ᵀ); for each dtmp[o, x, c] that such an element taps, 2
    per y tap (pass 1ᵀ); for t > 0 one add per df element. The positions
    and weights, shared by the C channels, are not counted."""
    ops = 0
    for t in range(warps.shape[1]):
        tr = warps[:, t]
        xt = _taps(warp_pallas._u_pos(tr, h, h), h)         # (N, O, XO)
        (_, y1), (_, y2) = _taps(warp_pallas._v_pos(tr, h, h), h)
        ny = (y1.long() + y2.long()).transpose(1, 2)         # (N, O, X)
        nx = xt[0][1].long() + xt[1][1].long()
        if idx is None:
            ops += c * ((2 * nx + 1 + (t > 0)).sum()
                        + (2 * ny * _reached(xt, ny.shape)).sum()).item()
        else:
            won = idx == t                                    # (N, O, XO, C)
            ops += (((1 + 2 * nx)[..., None] * won).sum()
                    + (2 * ny[..., None]
                       * _reached(xt, won.shape, won)).sum()).item() \
                + (won.numel() if t else 0)
    return ops


def warp_bytes(h, c, itemsize, idx_bytes) -> int:
    """Least bytes of one warp_fold (idx_bytes = the argmax written) or
    warp_fold_bwd (idx read): the map in, the map out, the masks, the
    transforms (32 bytes each)."""
    n, t = BATCH, PALLAS_PARTS
    return itemsize * (2 * n * h * h * c + n * t * h * h) + 32 * n * t \
        + (n * h * h * c if idx_bytes else 0)


def fwd_same(out, idx, ref, ref_idx) -> bool:
    """The forward check: ``out`` bit for bit its plain version's once −0
    is mapped to +0, ``idx`` bit for bit (see BWD_F32_REL's note)."""
    bits = torch.int16 if out.dtype == torch.bfloat16 else torch.int32
    same = torch.equal((out + 0.0).view(bits), (ref + 0.0).view(bits))
    return same and (idx is None or torch.equal(idx, ref_idx))


def _bf16_within(diff, ref, ulps) -> torch.Tensor:
    """Which elements lie within ``ulps`` bf16 ulps of their own magnitude,
    or, where parts nearly cancel, within 2^-16 of the largest."""
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs() + 1e-30)) - 7)
    return (diff <= ulps * ulp) | (diff <= 2.0 ** -16 * ref.abs().max())


def bwd_within(df, ref) -> bool:
    """The backward check: f32 within BWD_F32_REL of the largest element,
    bf16 within BWD_BF16_ULPS ulps of each element's own magnitude."""
    diff = (df.float() - ref.float()).abs()
    if df.dtype == torch.float32:
        return bool(diff.max() <= BWD_F32_REL * ref.float().abs().max())
    return bool(_bf16_within(diff, ref.float(), BWD_BF16_ULPS).all())


def _timed(call, accept, versions, flush, what) -> dict:
    """{version: ms per ``call(module)``}: each version's result held to
    ``accept`` first, then the versions timed in the given turns (baseline,
    current, current, baseline: drift of the card's clocks falls on
    both)."""
    spans: dict = {}
    for name, module in versions:
        if name not in spans:
            check(accept(call(module)), f"{what}: the {name} kernel "
                  "disagrees with its plain version")
        spans.setdefault(name, []).append(
            time_cuda(lambda: call(module), 20, flush))
    return {k: sum(v) / len(v) for k, v in spans.items()}


def phase_warp_kernels(flush, baseline=None, ablate=False) -> dict:
    """warp_fold and warp_fold_bwd against their plain versions at the
    fused fold's stages, on two input sets: ``random`` (``warp_inputs``,
    masks from {0, ¼, ½, 1}) and ``main`` (``main_path_inputs``, a training
    step's own transforms and masks: most parts' masks are 0 over most
    tiles). The forward bitwise apart from the sign of zeros (``fwd_same``),
    with and without the argmax; the backward within BWD_F32_REL /
    BWD_BF16_ULPS. Each line carries the share of (tile, part) pairs that
    the kernel counted as skipped (and, for the backward, as staged in more
    than one pass). With ``baseline`` (``load_baseline``) another version
    of both kernels is checked and timed in turns with these, its ms beside
    theirs; with ``ablate`` every set is also run as ``ablated``. The
    summaries sum the bf16 main-path variants (the forward without the
    argmax, as serving runs it; the backward) over the two stages, per
    input set."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    versions = [("current", warp_pallas)]
    if baseline is not None:
        versions = [("baseline", baseline), ("current", warp_pallas),
                    ("current", warp_pallas), ("baseline", baseline)]
    sums = {(k, s): _summary() for k in ("warp_fold", "warp_fold_bwd")
            for s in ("random", "main")}
    for dtype in (torch.bfloat16, torch.float32):
        for h, c in PALLAS_STAGES:
            sets = (("random", warp_inputs(h, c, dtype, gen)),
                    ("main", main_path_inputs(h, c, dtype)))
            for set_name, inputs in sets:
                for kind in (None, *(ABLATIONS if ablate else ())):
                    _check_warp_pair(
                        set_name if kind is None else f"{set_name}:{kind}",
                        *(inputs if kind is None else ablated(inputs, kind)),
                        gen, flush, versions, sums,
                        kind is None and dtype == torch.bfloat16)
    return sums


def _check_warp_pair(set_name, f, warps, masks, gen, flush, versions, sums,
                     summed):
    """One input set through both fused-fold kernels: checked, timed, its
    bound and the kernels' skip counts printed; its times added to ``sums``
    where ``summed``, its error to the set's max_abs_err always."""
    h, c = f.shape[1], f.shape[3]
    dname = str(f.dtype).split(".")[-1]
    bits = torch.int16 if f.dtype == torch.bfloat16 else torch.int32
    ops_f = warp_ops(warps, h, c)
    shape = {"N": BATCH, "H": h, "W": h, "C": c, "T": PALLAS_PARTS}
    idx = None
    for emit_idx in (False, True):
        ref, ref_idx = warp_pallas.warp_fold_pallas_reference(
            f, warps, masks, emit_idx)
        stats = torch.zeros(2, dtype=torch.int64, device="cuda")
        out, idx = warp_pallas.warp_fold(f, warps, masks, emit_idx, stats)
        torch.cuda.synchronize()
        same = fwd_same(out, idx, ref, ref_idx)
        err = (out.float() - ref.float()).abs().max().item()
        what = f"warp_fold {set_name} {dname} emit_idx={emit_idx} at " \
            f"{h}x{h}x{c}"
        check(same, f"{what}: not bitwise (±0 aside)")
        ms = _timed(lambda m: m.warp_fold(f, warps, masks, emit_idx),
                    lambda r: fwd_same(*r, ref, ref_idx), versions, flush,
                    what)
        plain_ms = time_cuda(lambda: warp_pallas.warp_fold_pallas_reference(
            f, warps, masks, emit_idx), 2, flush)
        res = {"ms": ms["current"], "plain_ms": plain_ms, **_bound(
            warp_bytes(h, c, out.element_size(), emit_idx), ops_f)}
        skipped, pairs = stats.tolist()
        emit({"phase": "kernel", "name": "warp_fold", "inputs": set_name,
              "dtype": dname, "emit_idx": emit_idx, "shape": shape,
              "bitwise_equal_but_zero_signs": same,
              "zero_signs_differing": int(
                  (out.view(bits) != ref.view(bits)).sum().item()),
              "max_abs_err": err, "operations": ops_f,
              "skipped_share": skipped / pairs,
              **({"baseline_ms": ms["baseline"]} if "baseline" in ms
                 else {}), **res})
        m = sums["warp_fold", set_name.split(":")[0]]
        m["max_abs_err"] = max(m["max_abs_err"], err)
        if summed and not emit_idx:
            _add(m, res)
    g = torch.randn(f.shape, generator=gen, device="cuda").to(f.dtype)
    ops_b = warp_ops(warps, h, c, idx)
    ref = warp_pallas.warp_fold_pallas_bwd_reference(g, warps, masks, idx)
    stats = torch.zeros(3, dtype=torch.int64, device="cuda")
    df = warp_pallas.warp_fold_bwd(g, warps, masks, idx, stats)
    torch.cuda.synchronize()
    diff = (df.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    ok = bwd_within(df, ref)
    what = f"warp_fold_bwd {set_name} {dname} at {h}x{h}x{c}"
    check(ok, f"{what}: max diff {diff.max().item()} of {scale}")
    ms = _timed(lambda m: m.warp_fold_bwd(g, warps, masks, idx),
                lambda r: bwd_within(r, ref), versions, flush, what)
    plain_ms = time_cuda(lambda: warp_pallas.warp_fold_pallas_bwd_reference(
        g, warps, masks, idx), 2, flush)
    res = {"ms": ms["current"], "plain_ms": plain_ms, **_bound(
        warp_bytes(h, c, g.element_size(), True), ops_b)}
    err = diff.max().item()
    skipped, multipass, pairs = stats.tolist()
    emit({"phase": "kernel", "name": "warp_fold_bwd", "inputs": set_name,
          "dtype": dname, "shape": shape, "within_tolerance": ok,
          "elements_differing": int((diff > 0).sum().item()),
          "elements": diff.numel(), "max_abs_err": err,
          "max_abs_ref": scale, "operations": ops_b,
          "skipped_share": skipped / pairs,
          "multipass_share": multipass / pairs,
          **({"baseline_ms": ms["baseline"]} if "baseline" in ms else {}),
          **res})
    m = sums["warp_fold_bwd", set_name.split(":")[0]]
    m["max_abs_err"] = max(m["max_abs_err"], err)
    if summed:
        _add(m, res)


def make_requests(rng, n, size):
    return [(random_image(rng, size),
             random_skeleton(rng, size, 18).astype(np.float32),
             random_skeleton(rng, size, 18).astype(np.float32))
            for _ in range(n)]


def check_images(out, n, what):
    check(out.shape == (n, 256, 256, 3), f"{what} shape {out.shape}")
    check(bool(np.isfinite(out).all()), f"{what} finite")
    check(bool((np.abs(out) <= 1.0).all()), f"{what} in [-1, 1]")


def _reset_counts() -> None:
    for counts in (warp_fused.LAUNCHES, warp_pallas.LAUNCHES):
        for k in counts:
            counts[k] = 0
    warp_mod.COUNTS["scan_fallback"] = 0


def _counts() -> dict:
    return {**warp_fused.LAUNCHES, **warp_pallas.LAUNCHES,
            "scan_fallback": warp_mod.COUNTS["scan_fallback"]}


def phase_serve(card: str, backend: str = "matmul") -> dict:
    """The full-width generator on the warp ``backend`` behind
    PoseTransferServer: a warm-up batch, two full batches of 8 and a padded
    partial batch of 3, outputs checked, fold kernel launches counted per
    forward; then one full batch held against a reference path with the
    same weights and inputs, in bf16 and f32: on 'matmul' the kernel-placed
    fold against the plain full-scan fold, on 'pallas' the fused fold
    against the 'matmul' backend."""
    cfg = GANConfig(image_size=(256, 256), pose_dim=18, batch_size=BATCH,
                    compute_dtype=torch.bfloat16, warp_backend=backend)
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
        _reset_counts()
        full = srv.generate(reqs[:2 * BATCH])
        stats = srv.stats()
        partial = srv.generate(reqs[2 * BATCH:])
        counts = _counts()
        batch = collate([srv.prepare_request(*r) for r in reqs[:BATCH]])
    check_images(full, 2 * BATCH, "full batches")
    check_images(partial, 3, "partial batch")
    forwards = stats["batches"] + 1
    place, fallbacks = counts["fold_place"], counts["scan_fallback"]
    # windowed stages: 256², 128², 64² on 'matmul'; 64² on 'pallas', whose
    # fused fold takes 256² and 128² (2 warp_fold launches, no argmax)
    windowed = 3 if backend == "matmul" else 1
    check(place + fallbacks == windowed * forwards,
          f"{place} fold_place launches + {fallbacks} fallbacks != "
          f"{windowed} per forward")
    check(place > 0, "serving launched no fold_place kernel")
    if backend == "pallas":
        check(counts["warp_fold"] == 2 * forwards
              and counts["warp_fold_idx"] == 0,
              f"{counts['warp_fold']} warp_fold launches != 2 per forward "
              f"({forwards} forwards), or some emitted the argmax")
    emit({"phase": "serve", "backend": backend, "requests": 2 * BATCH + 3,
          "forwards": forwards, "fold_place_launches": place,
          "warp_fold_launches": counts["warp_fold"],
          "scan_fallbacks": fallbacks,
          "fold_place_per_forward": place / forwards,
          "warp_fold_per_forward": counts["warp_fold"] / forwards,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    # one burst of 16 requests: a check that the server answers, not a
    # serving benchmark (tools/profile_serve.py measures under load)
    emit({"phase": "serve_smoke_stats", "backend": backend, "batch": BATCH,
          "dtype": "bfloat16", "card": card, **stats})

    if backend == "matmul":
        attr, ref, kernel, per_forward = "warp_windowed", False, \
            "fold_place", 3
        phase = "kernel_vs_plain_fold"
    else:
        attr, ref, kernel, per_forward = "warp_backend", "matmul", \
            "warp_fold", 2
        phase = "pallas_vs_matmul_backend"
    under_test = getattr(gen, attr)
    for dtype in (torch.bfloat16, torch.float32):
        gen.dtype = dtype
        step = make_eval_step(dataclasses.replace(cfg, compute_dtype=dtype),
                              gen)
        _reset_counts()
        out_k, _ = step(batch)
        one = _counts()
        setattr(gen, attr, ref)
        out_p, _ = step(batch)
        setattr(gen, attr, under_test)
        diff = (out_k.float() - out_p.float()).abs()
        res = {"phase": phase, "dtype": str(dtype).split(".")[-1],
               "launches": one[kernel], "scan_fallbacks": one["scan_fallback"],
               "max_abs_diff": diff.max().item(),
               "mean_abs_diff": diff.mean().item()}
        emit(res)
        check(one[kernel] == per_forward,
              f"{one[kernel]} {kernel} launches in one forward")
        if dtype == torch.bfloat16:
            check(res["max_abs_diff"] <= BF16_MAX_ABS
                  and res["mean_abs_diff"] <= BF16_MEAN_ABS,
                  f"bf16 {phase}")
        else:
            check(res["max_abs_diff"] <= F32_MAX_ABS, f"f32 {phase}")
    gen.dtype = torch.bfloat16
    return counts


def _stacked(batch: dict) -> dict:
    """One compact batch as the training_ratio=1 stack of draws."""
    return {k: v[None] for k, v in batch.items()}


def phase_train(card: str, backend: str = "matmul") -> dict:
    """Full-width bf16 training steps through the entry points a trainer
    calls: ``create_state`` then ``make_train_step``, on the warp
    ``backend``."""
    cfg = GANConfig(image_size=(256, 256), pose_dim=18, batch_size=BATCH,
                    compute_dtype=torch.bfloat16, warp_backend=backend)
    state = create_state(cfg, seed=0, device="cuda")
    n_gen = sum(p.numel() for p in state.gen.parameters())
    n_disc = sum(p.numel() for p in state.disc.parameters())
    check(n_gen == GEN_PARAMS, f"generator has {n_gen} parameters")
    check(n_disc == DISC_PARAMS, f"discriminator has {n_disc} parameters")
    check(state.gen.warp_windowed, "windowed fold on for CUDA training")
    step = make_train_step(cfg, state)
    rng = np.random.default_rng(2)

    def draw():
        return synthetic_compact_batch(rng, BATCH, cfg.image_size, 18)

    batches = [(_stacked(draw()), _stacked(draw()), draw())
               for _ in range(TRAIN_STEPS + 1)]
    step(*batches[0])                                   # warm-up
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in (*state.gen.parameters(),
                                            *state.disc.parameters())]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    metrics = [step(*b)[0] for b in batches[1:]]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {**warp_fused.LAUNCHES, **warp_pallas.LAUNCHES}
    fallbacks = warp_mod.COUNTS["scan_fallback"]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    rows = {k: torch.stack([m[k] for m in metrics]).tolist()
            for k in ("gen", "disc")}
    check(all(np.isfinite(rows[k]).all() for k in rows), f"losses {rows}")
    after = [p.detach() for p in (*state.gen.parameters(),
                                  *state.disc.parameters())]
    unmoved_gen = sum(torch.equal(a, b) for a, b in
                      zip(before[:len(list(state.gen.parameters()))], after))
    unmoved = sum(torch.equal(a, b) for a, b in zip(before, after))
    check(unmoved == 0, f"{unmoved_gen} generator and "
          f"{unmoved - unmoved_gen} discriminator tensors did not move")
    place, route = launches["fold_place"], launches["fold_route"]
    # windowed stages: 256², 128² and 64² on 'matmul'; 64² on 'pallas',
    # whose fused fold takes 256² and 128²
    windowed = 3 if backend == "matmul" else 1
    check(place + fallbacks == 2 * windowed * TRAIN_STEPS,
          f"{place} fold_place launches + {fallbacks} fallbacks != "
          f"{2 * windowed} per step (two forwards x {windowed} windowed "
          "stages)")
    if backend == "pallas":
        fused = (launches["warp_fold"], launches["warp_fold_idx"],
                 launches["warp_fold_bwd"])
        check(fused == (4 * TRAIN_STEPS, 2 * TRAIN_STEPS, 2 * TRAIN_STEPS),
              f"warp_fold / with the argmax / warp_fold_bwd launches "
              f"{fused} != 4 / 2 / 2 per step")
    check(route == launches["fold_place_idx"],
          f"{route} fold_route launches != {launches['fold_place_idx']} "
          "generator-phase fold_place launches with the argmax")
    check(route > 0 and place > 0, "training launched no fold kernel")
    images = BATCH * (2 * cfg.training_ratio + 1)
    emit({"phase": "train", "backend": backend, "card": card, "batch": BATCH,
          "dtype": "bfloat16",
          "steps": TRAIN_STEPS, "gen_params": n_gen, "disc_params": n_disc,
          "losses": {"gen [total, ll, ad]": rows["gen"],
                     "disc [total, true, fake]": rows["disc"]},
          "fold_place_launches": place,
          "fold_place_idx_launches": launches["fold_place_idx"],
          "fold_route_launches": route, "scan_fallbacks": fallbacks,
          "warp_fold_launches": launches["warp_fold"],
          "warp_fold_idx_launches": launches["warp_fold_idx"],
          "warp_fold_bwd_launches": launches["warp_fold_bwd"],
          "step_ms": wall_s / TRAIN_STEPS * 1e3,
          # 3 steps after one warm-up: a smoke reading, not a benchmark
          # (tools/profile_train.py measures); images per step counted as
          # N·(2·training_ratio + 1), the generator forwards' inputs
          "smoke_train_img_per_s": images * TRAIN_STEPS / wall_s,
          "peak_mem_gb": peak_gb})
    del state, step, before, after
    return launches


def phase_fold_grad(backend: str = "matmul") -> list:
    """The fold's f32 gradient through the kernels against autograd
    through the plain full-scan fold, at one real batch's warps and masks
    (seeded features and cotangent): on 'matmul' at the three windowed
    stages (fold_place with the argmax, fold_route), on 'pallas' at the two
    fused stages (warp_fold with the argmax, warp_fold_bwd)."""
    prep = make_batch_preparer(image_size=(256, 256), pose_dim=18,
                               device="cuda")(synthetic_compact_batch(
                                   np.random.default_rng(3), BATCH,
                                   (256, 256), 18))
    warps, masks = prep["warps"], prep["masks"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    stages = [(h, c) for h, c, _, _ in STAGES] if backend == "matmul" \
        else list(PALLAS_STAGES)
    res = []
    for h, c in stages:
        f = torch.randn((BATCH, h, h, c), generator=gen, device="cuda")
        g = torch.randn((BATCH, h, h, c), generator=gen, device="cuda")
        plan = warp_mod.plan_folds([tuple(f.shape)], warps, masks,
                                   torch.float32, windowed=True,
                                   backend=backend)[0]
        if backend == "matmul":
            check(plan.windows is not None and plan.fits,
                  f"stage {h}: the real batch does not take the windowed "
                  "fold")
        else:
            check(plan.pallas, f"stage {h}: not on the fused fold")
        _reset_counts()
        fk = f.clone().requires_grad_(True)
        warp_mod.affine_transform_layer(fk, warps, masks, (256, 256),
                                        windowed=True, plan=plan).backward(g)
        torch.cuda.synchronize()
        if backend == "matmul":
            ran = warp_fused.LAUNCHES["fold_route"] == 1 \
                and warp_fused.LAUNCHES["fold_place_idx"] == 1
        else:
            ran = warp_pallas.LAUNCHES["warp_fold_bwd"] == 1 \
                and warp_pallas.LAUNCHES["warp_fold_idx"] == 1
        check(ran, f"stage {h}: the kernel path did not run")
        fp = f.clone().requires_grad_(True)
        out, _ = warp_mod._fold_scan(fp, warps, plan.masks_r, (256, 256),
                                     "max", emit_idx=False)
        out.backward(g)
        diff = (fk.grad - fp.grad).abs()
        scale = fp.grad.abs().max().item()
        tol, share = (GRAD_REL_TOL, GRAD_FLIP_SHARE) if backend == "matmul" \
            else (PALLAS_GRAD_REL_TOL, PALLAS_GRAD_FLIP_SHARE)
        over = (diff > tol * scale).sum().item()
        r = {"phase": "fold_grad_kernel_vs_plain", "backend": backend,
             "dtype": "float32", "shape": [BATCH, h, h, c],
             "max_abs_ref": scale, "max_abs_diff": diff.max().item(),
             "mean_abs_diff": diff.mean().item(),
             "rel_tol": tol, "elements_over_tol": over,
             "elements": diff.numel()}
        emit(r)
        check(over <= share * diff.numel(),
              f"stage {h}: {over} gradient elements differ by more than "
              f"{tol} of the largest")
        res.append(r)
        del fk, fp, out, diff
    return res


def phase_fold_stream(card: str) -> int:
    """The fold microbenchmark's path at full width; returns the
    fold_place_stream launches of its partstream runs."""
    dev = torch.device("cuda")
    image = (256, 256)
    feats, warps, masks = bench_fold._fold_inputs(
        STREAM_BATCH, image, 18, 0, torch.bfloat16, dev)
    masks_r, sel, y0, x0, s_y, s_x = bench_fold._windows(feats, warps, masks)
    with torch.no_grad():
        body = (warp_mod._warp_full(feats, warps[:, 0], image)
                * masks_r[:, 0][..., None]).contiguous()
        wins = warp_mod._warp_win(feats, warps[:, sel], y0[:, sel],
                                  x0[:, sel], s_y, s_x, image).contiguous()
    mwins = warp_mod._slice_win(masks_r[:, sel], y0[:, sel], x0[:, sel], s_y,
                                s_x).contiguous()
    offs = warp_mod._place_offs(y0, x0, sel)
    zero_nb = (masks_r[:, 1:] == 0).any(dim=1)
    # the stream over part groups, bitwise against the monolithic kernel on
    # the same wins stack (the caller's body init and zero pass)
    for with_idx in (False, True):
        ref, ref_idx = warp_fused.fold_place(body, wins, mwins, zero_nb, offs,
                                             with_idx)
        for groups in STREAM_GROUPS:
            pg = len(sel) // groups
            acc = body.clone()
            idx = torch.zeros(acc.shape, dtype=torch.int8, device=dev) \
                if with_idx else None
            for k in range(0, len(sel), pg):
                warp_fused.fold_place_stream(
                    acc, idx, *(a[:, k:k + pg].contiguous()
                                for a in (wins, mwins, offs)))
            take0 = zero_nb[..., None] & (acc < 0)
            acc.masked_fill_(take0, 0)
            same = torch.equal(acc.view(torch.int16), ref.view(torch.int16))
            if with_idx:
                idx.masked_fill_(take0, -1)
                same = same and torch.equal(idx, ref_idx)
            emit({"phase": "fold_stream_vs_fold_place", "groups": groups,
                  "idx": with_idx, "shape": list(feats.shape),
                  "bitwise_equal": same})
            check(same, f"stream of {groups} groups (idx={with_idx}) != "
                  "fold_place")
    del body, wins, ref, ref_idx, acc, idx

    _reset_counts()
    for with_idx in (False, True):
        for groups in STREAM_GROUPS:
            for line in bench_fold.partstream(
                    feats, warps, masks, image, groups, with_idx,
                    BENCH_ITERS, BENCH_WARMUP):
                emit({"phase": "fold_stream_partstream", **line,
                      "card": card})
    counts = _counts()
    # per argmax setting (2) each leg runs once for its peak memory, then
    # its warm-up and timed calls; a stream call launches once per group
    calls = 2 * (1 + BENCH_WARMUP + BENCH_ITERS)
    check(counts["fold_place_stream"] == calls * sum(STREAM_GROUPS)
          and counts["fold_place"] == calls * len(STREAM_GROUPS),
          f"partstream launches {counts}")
    stream_launches = counts["fold_place_stream"]

    # the windowed fold's two placements, forward and feature gradient.
    # The forwards are held to the fold output limits (BF16_MAX_ABS,
    # BF16_MEAN_ABS, F32_MAX_ABS). The gradients of the fold's sum reach
    # ~400 here, where an absolute 0.05 is below one bf16 ulp; they are held
    # as this script holds fold gradients, all but GRAD_FLIP_SHARE of the
    # elements within BWD_BF16_ULPS bf16 ulps of their own magnitude (bf16)
    # or GRAD_REL_TOL of the largest (f32). The share is for ties: the
    # kernel's windows are wider, so where the running max is negative an
    # earlier part's zero-mask column places a ±0, and a later part whose
    # warp is exactly 0 there (bf16 sums do cancel) no longer wins it, as
    # it does under the (h/2, w/2) windows: both valid subgradients at an
    # exact-zero tie (3 output elements, 11 gradient elements, at b8 stage
    # 0 bf16 on an H100; f32 bitwise equal).
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        f = feats[:BATCH].to(dtype)
        mk = masks[:BATCH].to(dtype)
        for mode in ("fwd", "grad"):
            got = {}
            for variant in ("xla", "kernel"):
                call = bench_fold.variant_fold(variant, mode, f,
                                               warps[:BATCH], mk, image, 18)
                _reset_counts()
                got[variant] = call()
                one = _counts()
                ms = bench_fold.time_call(call, BENCH_ITERS, BENCH_WARMUP,
                                          dev)
                kernel = variant == "kernel"
                placed = (one["fold_place"], one["fold_place_idx"],
                          one["fold_route"])
                want = (1, int(mode == "grad"), int(mode == "grad")) \
                    if kernel else (0, 0, 0)
                check(one["scan_fallback"] == 0 and placed == want,
                      f"{variant} {mode} placement launches {one}")
                emit({"phase": "fold_stream_variant", "variant": variant,
                      "mode": mode, "batch": BATCH, "stage": 0,
                      "dtype": dname, "ms_per_call": ms,
                      "fold_place_launches": one["fold_place"],
                      "fold_route_launches": one["fold_route"],
                      "card": card})
            ref = got["kernel"].float()
            diff = (got["xla"].float() - ref).abs()
            scale = ref.abs().max().item()
            res = {"phase": "fold_stream_xla_vs_kernel", "mode": mode,
                   "dtype": dname, "max_abs_diff": diff.max().item(),
                   "mean_abs_diff": diff.mean().item(), "max_abs_ref": scale,
                   "elements_differing": int((diff > 0).sum().item()),
                   "elements": diff.numel()}
            if mode == "fwd" and dtype == torch.bfloat16:
                ok = res["max_abs_diff"] <= BF16_MAX_ABS \
                    and res["mean_abs_diff"] <= BF16_MEAN_ABS
            elif mode == "fwd":
                ok = res["max_abs_diff"] <= F32_MAX_ABS
            else:
                over = ~_bf16_within(diff, ref, BWD_BF16_ULPS) \
                    if dtype == torch.bfloat16 else diff > GRAD_REL_TOL * scale
                res["elements_over_tol"] = int(over.sum().item())
                ok = res["elements_over_tol"] <= GRAD_FLIP_SHARE * diff.numel()
            emit({**res, "within_tolerance": ok})
            check(ok, f"{dname} {mode}: xla vs kernel placement")
    return stream_launches


def _cli(fn, argv) -> tuple[str, float]:
    """Run one CLI entry point in this process: (its stdout, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue(), time.perf_counter() - t0


def _img_per_s(out: str) -> list:
    return [float(v) for v in re.findall(r"img/s : ([0-9.]+)", out)]


def phase_cli_h36m(card: str) -> dict:
    """The port's CLI flow at full width on h36m; returns the fold kernel
    launches of its training runs."""
    tmp = tempfile.TemporaryDirectory(prefix="cli_h36m_")
    root = Path(tmp.name)
    data = str(root / "data") + "/"
    flags = ["--expID", "h36m", "--data_Dir", data, "--dataset", "h36m",
             "--pose_dim", str(H36M_POSE), "--compute_dtype", "bfloat16",
             "--batch_size", str(BATCH), "--iters_per_epoch", str(CLI_ITERS),
             "--checkpoint_ratio", "1", "--display_ratio", "2",
             "--checkMode", "0", "--exp_root", str(root / "exp"),
             "--device", "cuda"]
    exp = root / "exp" / "h36m"
    _, secs = _cli(cli_data.main, ["--out", data, "--dataset", "h36m",
                                   "--pose_dim", str(H36M_POSE),
                                   "--images_per_person", str(CLI_FRAMES)])
    images = sorted((root / "data" / "h36m-dataset" / "train").iterdir())
    check(len(images) == 4 * CLI_FRAMES
          and all(p.suffix == ".png" for p in images), "dataset images")
    emit({"phase": "cli_h36m", "step": "make_synthetic_data",
          "seconds": secs, "images_per_split": len(images)})

    held = []
    save = checkpoint.save

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        save(*a, **k)
        held.append(time.perf_counter() - t0)

    seeks = []
    seek = BatchStream.seek_batches

    def counted_seek(self, k):
        seeks.append(k)
        seek(self, k)

    checkpoint.save, BatchStream.seek_batches = timed_save, counted_seek
    launches = {}
    try:
        for run, extra in (("train", ["--number_of_epochs", "2"]),
                           ("resume", ["--number_of_epochs", "3",
                                       "--resume", "1"])):
            held.clear()
            seeks.clear()
            _reset_counts()
            out, secs = _cli(cli_main.main, flags + extra)
            launches[run] = _counts()
            rows = [json.loads(ln) for ln in
                    (exp / "metrics.jsonl").read_text().splitlines()]
            ips = _img_per_s(out)
            epochs = (1, 2) if run == "train" else (2, 3)
            lines = [r for r in rows if r["epoch"] in epochs][-4:]
            check(len(ips) == 4 and all(
                math.isfinite(v) for r in lines for k, v in r.items()
                if k not in ("epoch", "it")), f"{run}: losses {lines}")
            saved = sorted(p.name for p in (exp / "models").iterdir())
            want = [f"{n}_{e:03d}.pt" for n in ("disc", "gen")
                    for e in range(1, epochs[1] + 1)]
            check(saved == want, f"{run}: checkpoints {saved}")
            # it 0 and 2 of each epoch so far (a resumed epoch rewrites its
            # files)
            grids = {d: len(list((exp / "results" / d).iterdir()))
                     for d in ("train", "test")}
            check(grids["train"] == grids["test"] == 2 * epochs[1],
                  f"{run}: grids {grids}")
            steps = 2 * CLI_ITERS
            place, route = (launches[run]["fold_place"],
                            launches[run]["fold_route"])
            check(place > 0 and route > 0,
                  f"{run}: fold_place {place}, fold_route {route} launches")
            if run == "resume":
                check("Resume gen from epoch 2" in out
                      and "Epoch : 1 " not in out, "resume at epoch 2")
                check(seeks == [CLI_ITERS * 3], f"stream seek {seeks}")
            emit({"phase": "cli_h36m", "step": f"main_{run}",
                  "seconds": secs, "card": card, "dataset": "h36m",
                  "batch": BATCH, "dtype": "bfloat16", "steps": steps,
                  "cli_img_per_s": ips,
                  "losses": [{k: r[k] for k in ("epoch", "it", "gen_total",
                                                "disc_total")}
                             for r in lines],
                  "fold_place_launches": place,
                  "fold_place_idx_launches":
                      launches[run]["fold_place_idx"],
                  "fold_route_launches": route,
                  "scan_fallbacks": launches[run]["scan_fallback"],
                  "warp_fold_launches": launches[run]["warp_fold"],
                  # a step's two generator forwards and one backward, and
                  # the test grid's forward at each display
                  "fold_place_per_iteration": place / CLI_ITERS / 2,
                  "fold_route_per_iteration": route / CLI_ITERS / 2,
                  "save_held_loop_s": list(held), "stream_seeks": seeks})
    finally:
        checkpoint.save, BatchStream.seek_batches = save, seek

    out, secs = _cli(cli_test.main, flags + ["--resume", "1"])
    grids = sorted(p.name for p in
                   (exp / "results" / "generated").iterdir())
    # frame i → i + 2: CLI_FRAMES - 2 test pairs a person, 4 people
    want = [f"images_batch_{b:05d}.png"
            for b in range(4 * (CLI_FRAMES - 2) // BATCH)]
    check("epoch-3 weights" in out and grids == want,
          f"cli.test grids {grids}")
    emit({"phase": "cli_h36m", "step": "test", "seconds": secs,
          "grids": len(grids)})

    out, secs = _cli(cli_evaluate.main, flags + ["--resume", "1",
                                                 "--max_batches", "2"])
    res = json.loads(out.strip().splitlines()[-1])
    check(res["epoch"] == 3 and res["num_batches"] == 2
          and all(math.isfinite(res[k]) for k in (
              "value", "l1", "psnr", "feat_l2", "feat_l1", "feat_nn"))
          and -1.0 <= res["value"] <= 1.0, f"cli.evaluate {res}")
    emit({"phase": "cli_h36m", "step": "evaluate", "seconds": secs,
          "result": res})
    tmp.cleanup()
    return {k: launches["train"][k] + launches["resume"][k]
            for k in launches["train"]}


def phase_fold_h36m() -> None:
    """The h36m 224² fold through the kernels (fold_place with the argmax,
    fold_route) against the plain full scan, at a real pose_dim-16 batch's
    warps and masks (the 5 static-empty parts compacted out on both
    sides): forward and feature gradient, bf16 and f32. Forwards within
    the serving limits (BF16_MAX_ABS, BF16_MEAN_ABS, F32_MAX_ABS); f32
    gradients as phase_fold_grad holds them (GRAD_REL_TOL of the largest),
    bf16 gradients within BWD_BF16_ULPS of each element's magnitude, both
    up to GRAD_FLIP_SHARE of the elements (near-ties)."""
    prep = make_batch_preparer(image_size=H36M, pose_dim=H36M_POSE,
                               device="cuda")(synthetic_compact_batch(
                                   np.random.default_rng(5), BATCH, H36M,
                                   H36M_POSE))
    static = static_empty_parts(H36M_POSE)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    h, c = H36M[0], 64
    for dtype in (torch.bfloat16, torch.float32):
        warps, masks = prep["warps"].to(dtype), prep["masks"].to(dtype)
        f = torch.randn((BATCH, h, h, c), generator=gen,
                        device="cuda").to(dtype)
        g = torch.randn((BATCH, h, h, c), generator=gen,
                        device="cuda").to(dtype)
        plan = warp_mod.plan_folds([tuple(f.shape)], warps, masks, dtype,
                                   windowed=True, static_empty=static)[0]
        check(plan.windows is not None and not plan.xla and plan.fits,
              "the h36m batch does not take the kernel-placed fold at 224²")
        _reset_counts()
        fk = f.clone().requires_grad_(True)
        out_k = warp_mod.affine_transform_layer(
            fk, warps, masks, H36M, windowed=True, static_empty=static,
            plan=plan)
        out_k.backward(g)
        torch.cuda.synchronize()
        one = _counts()
        check(one["fold_place_idx"] == 1 and one["fold_route"] == 1,
              f"h36m fold kernels {one}")
        fp = f.clone().requires_grad_(True)
        out_p, _ = warp_mod._fold_scan(fp, warps, plan.masks_r, H36M, "max",
                                       static_empty=static, emit_idx=False)
        out_p.backward(g)
        dname = str(dtype).split(".")[-1]
        fdiff = (out_k.float() - out_p.float()).abs()
        ref = fp.grad.float()
        gdiff = (fk.grad.float() - ref).abs()
        scale = ref.abs().max().item()
        if dtype == torch.bfloat16:
            fwd_ok = fdiff.max().item() <= BF16_MAX_ABS \
                and fdiff.mean().item() <= BF16_MEAN_ABS
            ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
            over = gdiff > H36M_BF16_GRAD_ULPS * ulp
        else:
            fwd_ok = fdiff.max().item() <= F32_MAX_ABS
            over = gdiff > GRAD_REL_TOL * scale
        over = int(over.sum().item())
        emit({"phase": "fold_h36m_kernel_vs_plain", "dtype": dname,
              "shape": [BATCH, h, h, c], "static_empty": list(static),
              "fwd_max_abs_diff": fdiff.max().item(),
              "fwd_mean_abs_diff": fdiff.mean().item(),
              "grad_max_abs_ref": scale,
              "grad_max_abs_diff": gdiff.max().item(),
              "grad_elements_over_tol": over, "elements": gdiff.numel()})
        check(fwd_ok, f"h36m {dname} fold forward")
        check(over <= GRAD_FLIP_SHARE * gdiff.numel(),
              f"h36m {dname} fold gradient: {over} elements over")
        del fk, fp, out_k, out_p


def phase_pallas_h36m() -> None:
    """warp_backend='pallas' at h36m: no stage passes the fused fold's
    gate (224 % 128 != 0), so every stage takes the 'matmul' fold, no
    warp_fold launches and the output is the 'matmul' backend's, bit for
    bit (one generator, cuDNN held deterministic for the comparison)."""
    cfg = GANConfig(image_size=H36M, pose_dim=H36M_POSE, batch_size=BATCH,
                    compute_dtype=torch.bfloat16, warp_backend="pallas")
    gen = build_models(cfg, seed=0, device="cuda")
    step = make_eval_step(cfg, gen, "cuda")
    batch = synthetic_compact_batch(np.random.default_rng(7), BATCH, H36M,
                                    H36M_POSE)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _reset_counts()
        out_pallas, _ = step(batch)
        one = _counts()
        gen.warp_backend = "matmul"
        out_matmul, _ = step(batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = torch.equal(out_pallas, out_matmul)
    emit({"phase": "pallas_h36m_forward", "warp_fold_launches":
          one["warp_fold"], "fold_place_launches": one["fold_place"],
          "scan_fallbacks": one["scan_fallback"], "equal_to_matmul": same,
          "max_abs_diff": (out_pallas.float() - out_matmul.float()).abs()
          .max().item()})
    check(one["warp_fold"] == 0 and one["warp_fold_idx"] == 0,
          f"'pallas' at h36m launched warp_fold: {one}")
    check(same, "'pallas' h36m forward differs from 'matmul'")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Smoke run of the PyTorch port "
                                "on one CUDA card (see the module's notes).")
    p.add_argument("--baseline", metavar="DIR", default=None,
                   help="another checkout of this repo (e.g. the parent "
                   "commit, unpacked with git archive): phase 3 also checks "
                   "its warp_fold and warp_fold_bwd and times them in turns "
                   "with these (baseline_ms)")
    p.add_argument("--ablate", action="store_true",
                   help="phase 3 also runs the fused fold's kernels on "
                   "ablated inputs (sentinel or identity transforms, zero "
                   "masks)")
    args = p.parse_args(argv)
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
    main_k = phase_kernels(flush)
    baseline = None if args.baseline is None \
        else load_baseline(args.baseline)
    warp_sums = phase_warp_kernels(flush, baseline, args.ablate)
    for name in ("warp_fold", "warp_fold_bwd"):
        # the line reads the random set, as since the kernels' first port;
        # the main path's own inputs ride along as *_main
        rand, on_main = warp_sums[name, "random"], warp_sums[name, "main"]
        main_k[name] = {**rand, "max_abs_err": max(
            rand["max_abs_err"], on_main["max_abs_err"]),
            **{f"{k}_main": on_main[k] for k in ("ms", "plain_ms",
                                                 "bound_ms")}}
    del flush
    serve_launches = phase_serve(smi)
    train_launches = phase_train(smi)
    phase_fold_grad()
    pallas_serve = phase_serve(smi, "pallas")
    pallas_train = phase_train(smi, "pallas")
    phase_fold_grad("pallas")
    stream_launches = phase_fold_stream(smi)
    cli_launches = phase_cli_h36m(smi)
    phase_fold_h36m()
    phase_pallas_h36m()

    tpu = "pose_transfer_tpu/ops/"
    rows = (
        ("fold_place",
         serve_launches["fold_place"] + train_launches["fold_place"]
         + cli_launches["fold_place"], tpu + "warp_fused.py:189", []),
        ("fold_route", train_launches["fold_route"]
         + cli_launches["fold_route"], tpu + "warp_fused.py:380", []),
        # the forward's two passes (pass 1 :223, pass 2 :243), fused
        ("warp_fold", pallas_serve["warp_fold"] + pallas_train["warp_fold"],
         tpu + "warp_pallas.py:223", [tpu + "warp_pallas.py:243"]),
        # the backward's two transposed passes (:288, :307), fused
        ("warp_fold_bwd", pallas_train["warp_fold_bwd"],
         tpu + "warp_pallas.py:288", [tpu + "warp_pallas.py:307"]),
        ("fold_place_stream", stream_launches,
         tpu + "warp_fused.py:300", []),
    )
    kernels = []
    for name, launches, replaces, also in rows:
        m = main_k[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pose_transfer_torch/csrc/{name}.cu",
            "replaces": replaces, "also_replaces": also,
            "launches": launches, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": "bytes" if m["bytes_ms"] >= m["ops_ms"]
            else "operations",
            "library_ms": None, "checked_vs_plain": True,
            **{k: v for k, v in m.items() if k.endswith("_main")}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
