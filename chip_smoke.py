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
              over 9 parts in groups of 3 at the windowed stages;
              fold_place and fold_route also at h36m's 224² stage (4 parts,
              zero_nb all ones); warp_taps (bitwise, and against the banded
              products) and warp_taps_t (within a stated tolerance) at
              every fold stage of the benchmark cells at batch 32, the
              windows' call and the full map's (TAPS_STAGES);
              volume_norm_fwd and volume_norm_bwd at each dataset's largest
              normed volume at b32 (NORM_SHAPES), bf16 and f32, held to the
              plain norm and autograd through it within stated limits, two
              calls bit for bit, timed beside their byte bound, the plain
              version and torch.nn.functional.group_norm(x, 1)
  4. serve    the full-width fashion-256 deformable generator (bf16, seeded
              random weights) behind PoseTransferServer: two full batches
              of 8 and a padded partial batch of 3; outputs checked, fold,
              tap and norm kernel launches counted, the kernel-placed fold held
              against the plain full-scan fold on the banded warps
  5. train    the two-phase GAN step at full width (generator and
              discriminator, bf16, batch 8, seeded): one warm-up step and 3
              steps on synthetic batches; losses finite, both nets' weights
              moved, fold_place, fold_route and norm launches counted
              (GEN_NORMS, DISC_NORMS; also in the recipe's and the stacked
              generator's steps); then the
              fold's gradient through the kernels (fold_place with the
              argmax, fold_route, warp_taps, warp_taps_t) held against
              autograd through the plain full-scan fold on the banded
              warps, in f32
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
  9. recipe   the reference's full_fasion recipe at full width (fashion-256,
              bf16, batch 8: VGG19 block1_conv2 content loss over seeded
              random filters, nn_loss of area 5, L1 weight 1.0): one
              warm-up and 3 steps on 'matmul', one warm-up and one step on
              'pallas'; losses finite, both nets' weights moved, the fold
              kernels' launches counted per step, one nn_loss_fwd and one
              nn_loss_bwd launch a step; then nn_loss's plain routed code
              (f32) against autograd through its plain primal at a step's
              own VGG features, bit for bit where one shift is the unique
              minimum, and to the first minimal shift's routing
              everywhere, with both versions' times and peak memory; then
              the nn_loss kernels (csrc/nn_loss.cu) against that plain
              code at the benchmark cell's shape (b32, 256²×64, area 5):
              the loss within 1e-6, the index equal on 99.99 % of the
              pixels and elsewhere a near tie, the cotangent bit for bit
              where the index agrees, two calls bit for bit; each
              kernel's largest error against the plain code, its ms with
              a cold L2, the plain code's and the least time of its bytes
              and operations (these launches are left out of the kernels
              line's counts, which count the main paths' alone)
 10. stacked  the stacked generator (num_stacks 4, fashion-256, bf16)
              behind PoseTransferServer on both backends: a full batch of
              8 and a padded partial batch of 3, 4x the baseline's fold
              launches a forward, 'pallas' held to 'matmul' within the
              serving limits stage by stage (each 'pallas' stage fed the
              'matmul' stage's input; the served images' difference, 4
              chained bf16 generators, reported beside); then one warm-up
              and 3 stacked train steps on 'matmul' (launches, peak memory)
 11. unet     the U-Net behind PoseTransferServer: one batch of 8, no fold
              kernel launched
 12. cli_recipe the CLIs at full width on a seeded fasion PNG dataset (4
              people x 3 images, batch 8, bf16): a full_fasion content-loss
              run of 3 iterations, a stacked run that warm-starts from its
              checkpoint, cli.test's stacked grids, cli.evaluate's finite
              metrics on the last stage
 13. http_serve the HTTP front (cli.serve) at full width: a fashion-256
              generator and discriminator (bf16, seeded) after one training
              step, written as the JAX package's gen_001.msgpack and
              disc_001.msgpack (models.import_flax's inverse map,
              utils.flax_msgpack's encoder); build_server --resume 1 reads
              them bit for bit; make_http_server on loopback answers 2 full
              batches of 8 and 3 requests sent concurrently (200, uint8
              256², held against the eval step within the serving limits
              on the uint8 scale; fold_place 3 a forward; /stats counts
              them; /healthz; a malformed body and a wrong-shape image 400);
              then HTTP requests/s for 384 requests from 16 client threads
              beside the same server's in-process capacity
 14. resume_msgpack cli.main --resume 1 on those files: one epoch of 2
              iterations at b8, resumed at epoch 1 and the file's step with
              both nets and both Adam states bit for bit the written ones;
              losses finite, launches counted, .pt files written
 15. exact    warp_backend='exact': warp_feature_single against grid_sample
              and the exact fold against the 'matmul' fold (m10 = 0) at
              256²×64 f32; a serving forward and 2 training steps at b8
              bf16 launching no fold kernel, ms and peak memory beside
              'matmul''s
 16. keras    the Keras importer at full width: a seeded generator's and
              discriminator's weights as Keras-order layer lists through
              import_generator_keras / import_discriminator_keras, forwards
              bit for bit those of the modules they came from
 17. chunked  the fold's memory chunking (fashion-256, bf16, 'matmul'): the
              stage-0 kernel-placed fold at b32, forward and gradient, under
              the default PT_WARP_PLACE_CHUNK_MB (one call), a 512 MB cap
              (chunks 9, 9, 9, 5) and PT_WARP_JOINT_GROUP=3, held to the
              one-call fold (tolerances stated at CHUNK_SETTINGS), one
              fold_place / fold_route launch per chunk, ms and peak memory
              each (tools/bench_fold.py's batchchunk experiment); 2 training
              steps at b64 (stage 0 in chunks of 54 and 10) and at b32:
              losses finite, nets moved, one launch per chunk of every fold
              instance (the chunks per stage stated at CHUNK_TRAIN_WANT),
              ms and peak memory
 18. data_parallel fashion-256 at full width, bf16, global batch 16, 2
              steps, dropout on: (a) one process; (b) 2 spawned ranks on
              the card over gloo (CUDA tensors), both ranks' nets bitwise
              equal, every phase's all-reduced gradients and every step's
              losses held to (a)'s (DP_GRAD_RTOL, DP_LOSS_TOL), the nets
              within JAX's mesh-test tolerance; (c) 1 rank over NCCL in
              this process, held to (a) the same way, with the
              all-reduce's ms a step; (d) cli.main --device cuda:0
              --num_devices 2 (1 epoch of 2 iterations, a display, a
              checkpoint written by rank 0 alone), then --resume 1 on one
              device; (e) PoseTransferServer with 2 replicas on the card
              against one, within the serving limits. Launches counted in
              every part; the ranks are joined with a time limit; no time
              here is a scaling result (one card)
 19. the kernels line (warp_fold and warp_fold_bwd: ms and bounds on the
     random set, as since their first port; ms_main, plain_ms_main and
     bound_ms_main on a training step's own inputs; warp_taps and
     warp_taps_t: summed over fashion's bf16 calls of phase 3; launches
     summed over every path that drives them), then the last line
     {"ok": true, "device": {...}}

Exits non-zero without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from portbench import measure
from pose_transfer_torch import _build
from pose_transfer_torch.cli import evaluate as cli_evaluate
from pose_transfer_torch.cli import main as cli_main
from pose_transfer_torch.cli import make_synthetic_data as cli_data
from pose_transfer_torch.cli import serve as cli_serve
from pose_transfer_torch.cli import test as cli_test
from pose_transfer_torch.cli.opts import Opts
from pose_transfer_torch.core.transforms_host import static_empty_parts
from pose_transfer_torch.data.loader import BatchStream
from pose_transfer_torch.data.dataset import collate
from pose_transfer_torch.data.device import make_batch_preparer
from pose_transfer_torch.data.synthetic import random_image, random_skeleton
from pose_transfer_torch.models import import_flax, import_keras
from pose_transfer_torch.models import vgg as vgg_mod
from pose_transfer_torch.models.networks import Discriminator
from pose_transfer_torch.ops import nn_loss as nn_loss_mod
from pose_transfer_torch.ops import norm as norm_mod
from pose_transfer_torch.ops import warp as warp_mod
from pose_transfer_torch.ops import warp_fused
from pose_transfer_torch.ops import warp_pallas
from pose_transfer_torch.ops.launches import (launch_counts,
                                              reset_launch_counts)
from pose_transfer_torch.parallel import dryrun
from pose_transfer_torch.parallel import mesh as pmesh
from pose_transfer_torch.serve import PoseTransferServer
from pose_transfer_torch.data.synthetic import synthetic_compact_batch
from pose_transfer_torch.tools import bench_fold, profile_serve
from pose_transfer_torch.train import checkpoint
from pose_transfer_torch.train.engine import (GANConfig, batch_preparer,
                                              build_models, create_state,
                                              make_eval_step,
                                              make_train_step)
from pose_transfer_torch.utils import flax_msgpack
from pose_transfer_torch.utils.image_io import read_image

GEN_PARAMS = 82_080_611       # fashion-256 generator (reference logs)
DISC_PARAMS = 2_803_782       # fashion discriminator (reference logs)
TRAIN_STEPS = 3
# fashion-256 fold stages that take the windowed fold:
# (H = W, C, SY, SX) for skips 256²×64, 128²×128, 64²×256; P = 9 parts
STAGES = ((256, 64, 128, 144), (128, 128, 64, 80), (64, 256, 32, 48))
BATCH, PARTS = 8, 9
# h36m-224's kernel-placed stage: 224²×64, windows 112 × 128, the 4 parts
# that pose_dim 16 leaves active, zero_nb all ones (static-empty parts)
H36M_PLACE_STAGE, H36M_PARTS = (224, 64, 112, 128), 4
# phase 3's fold_place / fold_route shapes: (stage, P, zero_nb all ones,
# dataset); the kernels line sums fashion's, as since the first port
PLACE_SHAPES = tuple((st, PARTS, False, "fasion") for st in STAGES) \
    + ((H36M_PLACE_STAGE, H36M_PARTS, True, "h36m"),)
STREAM_PG = 3                 # parts per fold_place_stream group (phase 3)
# phase 3's warp_taps / warp_taps_t calls: every fold stage of the
# benchmark cells at their batch, (image, pose_dim, stage, dataset), on a
# real batch's transforms and windows (tools/bench_fold.py's inputs). A
# windowable stage makes the windows' call (all its active non-body parts;
# the placement kernel's windows where the stage has them, else the
# XLA-style (h/2, w/2) ones), every stage the full-map call (one part, as
# the body's and the scan's warps make it); the windows' transpose runs
# joint (f32 out), the full map's not (rounded to the dtype), as the fold's
# backward calls them. The kernels line sums fashion's bf16 calls.
TAPS_STAGES = tuple(((256, 256), 18, k, "fasion") for k in range(4)) \
    + tuple(((224, 224), 16, k, "h36m") for k in range(4))
TAPS_BATCH = 32
# warp_taps: bitwise its plain version (the same f32 operations in the same
# order); within TAPS_REL of the largest magnitude of the banded products:
# cuBLAS's f32 sum of a pass's two products may round otherwise and flip a
# bf16 rounding, rarely (a few elements a call, in lower binades than the
# largest), so bf16 within one rounding of the largest; f32 a few ulps.
# warp_taps_t against its plain version, which scatters the taps with
# index_add_ (atomics, in no fixed order) where the kernel gathers them in
# a fixed one: its f32 sums run in another order, and in bf16 a flipped
# rounding of pass 1 (and, off joint, of pass 2) enters the result: within
# TAPS_T_REL of the largest magnitude. The limits of
# tests/test_torch_warp_taps.py at batch 2.
TAPS_REL = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -20}
TAPS_T_REL = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -18}
# operations per window element: two taps a pass, a multiply and an add
# each, at the two source columns of pass 1 and once in pass 2
TAPS_OPS = 12
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
# phases 9-12: the reference's full_fasion recipe and the stacked generator
RECIPE = dict(content_loss_layer="block1_conv2", nn_loss_area_size=5,
              l1_penalty_weight=1.0)
NUM_STACKS = 4
# fold kernel launches of one baseline fashion-256 forward (windowed stages
# 256², 128², 64² on 'matmul'; 64² on 'pallas', whose fused fold takes 256²
# and 128²) and of one training step (two forwards, one backward); the
# stacked generator runs NUM_STACKS such forwards
# warp_taps: 2 at a placed stage (body, windows), 1 a part (T = 10) at the
# 32² scan; warp_taps_t the same in the backward. A fold that falls back to
# the scan warps its T parts one by one where the placed fold warps twice:
# TAPS_PER_FALLBACK more launches in its forward (and in its backward, where
# the forward had one)
PER_FORWARD = {"matmul": {"fold_place": 3, "warp_fold": 0, "warp_taps": 16},
               "pallas": {"fold_place": 1, "warp_fold": 2, "warp_taps": 12}}
PER_STEP = {"matmul": {"fold_place": 6, "fold_place_idx": 3, "fold_route": 3,
                       "warp_fold": 0, "warp_fold_idx": 0,
                       "warp_fold_bwd": 0, "warp_taps": 32,
                       "warp_taps_t": 16},
            "pallas": {"fold_place": 2, "fold_place_idx": 1, "fold_route": 1,
                       "warp_fold": 4, "warp_fold_idx": 2,
                       "warp_fold_bwd": 2, "warp_taps": 24,
                       "warp_taps_t": 12}}
TAPS_PER_FALLBACK = PARTS + 1 - 2
# volume_norm launches: one volume_norm_fwd per normed Block a forward
# runs (fashion-256's generator: 5 in each encoder, 6 in the decoder; the
# discriminator 3), one volume_norm_bwd per normed Block a backward passes;
# a step runs the generator and the discriminator forward twice, the
# generator backward once and the discriminator twice
GEN_NORMS, DISC_NORMS = 16, 3
# phase 3's volume_norm shapes: each dataset's largest normed volume at
# b32 (the decoder's last Block), channels-last as the networks run it
NORM_SHAPES = (((32, 128, 256, 256), "fasion"), ((32, 128, 224, 224), "h36m"))
NORM_EPS = 1e-3
# the kernels against the plain function and autograd through it, as
# tests/test_torch_norm_kernel.py holds them: the f32 sums run in another
# order (within NORM_F32_REL of the largest magnitude), and in bf16 an
# element rounded once from those f32 values may take the neighbouring
# value (one ulp of its own magnitude, NORM_BF16_ULP, beyond that)
NORM_F32_REL, NORM_BF16_ULP = 1e-5, 2.0 ** -7


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


def place_inputs(h, c, sy, sx, dtype, gen, p=PARTS, zero_all=False):
    """fold_place inputs: negatives in the body, zeros and fractions in the
    mask windows, x0 ≡ 0 mod 16, exact ties (part 2 repeats part 1);
    ``p`` placed parts; ``zero_all``: zero_nb all ones, as where some parts
    are static-empty (h36m)."""
    dev = "cuda"
    n, w = BATCH, h
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
    if zero_all:
        zero_nb = torch.ones_like(zero_nb)
    return (body.contiguous(), wins.to(dtype).contiguous(),
            mwins.to(dtype).contiguous(), zero_nb, offs)


def route_inputs(h, c, sy, sx, dtype, gen, p=PARTS):
    """fold_route inputs: g with negatives, the mask windows and offsets of
    ``place_inputs`` (zeros among the mask values: signed zeros; two parts
    sharing a window), idx drawn from -1 (zero pass), 0 (body) and the
    parts, a body mask with zeros."""
    g, _, mwins, _, offs = place_inputs(h, c, sy, sx, dtype, gen, p)
    idx = torch.randint(-1, p + 1, g.shape, generator=gen,
                        device="cuda").to(torch.int8)
    levels = torch.tensor([0.0, 0.5, 1.0], device="cuda")
    mask0 = levels[torch.randint(0, 3, (BATCH, h, h), generator=gen,
                                 device="cuda")].to(dtype)
    return g, idx, mask0, mwins, offs


def nn_loss_bytes(n, h, w, c, direction: str, reached: int = 0) -> int:
    """Least bytes of one nn_loss launch on f32 maps with a uint8 index:
    the forward reads both maps once and writes the index; the backward
    reads the prediction and the index, writes the prediction's cotangent
    and reads the ``reached`` target pixels that the index points at."""
    if direction == "fwd":
        return 2 * n * h * w * c * 4 + n * h * w
    return (2 * n * h * w + reached) * c * 4 + n * h * w


def nn_loss_ops(n, h, w, c, area: int, direction: str) -> int:
    """Operations of one nn_loss launch: the forward a subtract, an abs
    and an add per channel, shift and pixel; the backward a subtract and a
    multiply per element."""
    if direction == "fwd":
        return 3 * area * area * n * h * w * c
    return 2 * n * h * w * c


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


def _least_time(nbytes: int, ops: float) -> dict:
    """A launch's least time on the card by the benchmark's model
    (``portbench.measure.least_seconds``: bytes at the HBM rate or
    operations at the f32 rate, whichever binds), with both parts."""
    bytes_ms = measure.least_seconds(nbytes, 0) * 1e3
    ops_ms = measure.least_seconds(0, ops) * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": measure.least_seconds(nbytes, ops) * 1e3,
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
            "fold_place_stream": _summary(), "warp_taps": _summary(),
            "warp_taps_t": _summary()}
    for dtype, bits in ((torch.bfloat16, torch.int16),
                        (torch.float32, torch.int32)):
        dname = str(dtype).split(".")[-1]
        for emit_idx in (False, True):
            for (h, c, sy, sx), p, zero_all, dataset in PLACE_SHAPES:
                args = place_inputs(h, c, sy, sx, dtype, gen, p, zero_all)
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
                res = {"ms": ms, "plain_ms": plain_ms, **_least_time(
                    measure.place_bytes(BATCH, h, h, c, p, sy, sx,
                                        out.element_size(), emit_idx),
                    2 * BATCH * p * sy * sx * c)}
                emit({"phase": "kernel", "name": "fold_place", "dtype": dname,
                      "emit_idx": emit_idx, "dataset": dataset,
                      "shape": {"N": BATCH, "H": h, "W": h, "C": c,
                                "P": p, "SY": sy, "SX": sx},
                      "zero_nb_all_ones": zero_all,
                      "bitwise_equal": same, "max_abs_err": err, **res})
                m = main["fold_place"]
                m["max_abs_err"] = max(m["max_abs_err"], err)
                if dtype == torch.bfloat16 and not emit_idx \
                        and dataset == "fasion":
                    _add(m, res)
        for (h, c, sy, sx), p, _, dataset in PLACE_SHAPES:
            args = route_inputs(h, c, sy, sx, dtype, gen, p)
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
            res = {"ms": ms, "plain_ms": plain_ms, **_least_time(
                measure.route_bytes(BATCH, h, h, c, p, sy, sx,
                                    out[0].element_size()),
                2 * BATCH * (p * sy * sx + h * h) * c)}
            emit({"phase": "kernel", "name": "fold_route", "dtype": dname,
                  "dataset": dataset,
                  "shape": {"N": BATCH, "H": h, "W": h, "C": c, "P": p,
                            "SY": sy, "SX": sx},
                  "bitwise_equal": same, "max_abs_err": err, **res})
            m = main["fold_route"]
            m["max_abs_err"] = max(m["max_abs_err"], err)
            if dtype == torch.bfloat16 and dataset == "fasion":
                _add(m, res)
        for with_idx in (False, True):
            for h, c, sy, sx in STAGES:
                res, err = _check_stream(h, c, sy, sx, dtype, bits, with_idx,
                                         gen, flush)
                m = main["fold_place_stream"]
                m["max_abs_err"] = max(m["max_abs_err"], err)
                if dtype == torch.bfloat16 and not with_idx:
                    _add(m, res)
    for image, pose_dim, stage, dataset in TAPS_STAGES:
        _check_taps(image, pose_dim, stage, dataset, main, flush)
    main["volume_norm_fwd"], main["volume_norm_bwd"] = _check_norm(flush)
    return main


def _norm_within(got, want, dtype) -> bool:
    got, want = got.float(), want.float()
    tol = NORM_F32_REL * want.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + NORM_BF16_ULP * want.abs()
    return bool(((got - want).abs() <= tol).all())


def _check_norm(flush) -> tuple[dict, dict]:
    """volume_norm_fwd and volume_norm_bwd at NORM_SHAPES, bf16 and f32:
    held to the plain function (the output) and autograd through it (the
    input's, weight's and bias's cotangents), two calls bit for bit; ms
    with a cold L2 beside the least time of the bytes, the plain version's
    ms and the ms of torch.nn.functional.group_norm(x, 1), one PyTorch call
    with the same statistics that the port never calls (its backward by
    autograd). The summaries sum fashion's bf16 calls."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    w = torch.tensor([1.3], device="cuda")
    b = torch.tensor([-0.2], device="cuda")
    sums = {"fwd": _summary(), "bwd": _summary()}
    for shape, dataset in NORM_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            x, g = ((torch.randn(shape, generator=gen, device="cuda") * scale
                     + shift).to(dtype).contiguous(
                         memory_format=torch.channels_last)
                    for scale, shift in ((1.5, 0.7), (1.0, 0.0)))
            y, stats = norm_mod.volume_norm_fwd(x, w, b, NORM_EPS)
            dx, dwb = norm_mod.volume_norm_bwd(x, g, w, stats)
            y2, stats2 = norm_mod.volume_norm_fwd(x, w, b, NORM_EPS)
            dx2, dwb2 = norm_mod.volume_norm_bwd(x, g, w, stats2)
            repeat = all(torch.equal(p, q) for p, q in
                         ((y, y2), (stats, stats2), (dx, dx2), (dwb, dwb2)))
            xr, wr, br = (t.detach().clone().requires_grad_(True)
                          for t in (x, w, b))
            ref = norm_mod.volume_instance_norm_reference(xr, wr, br,
                                                          NORM_EPS)
            rdx, rdw, rdb = torch.autograd.grad(ref, (xr, wr, br), g,
                                                retain_graph=True)
            xh_abs = (g.float() * ((ref.detach().float() - b) / w)).abs()
            errs = {"fwd": (y.float() - ref.detach().float()).abs().max()
                    .item(),
                    "bwd": (dx.float() - rdx.float()).abs().max().item()}
            ok = {"fwd": _norm_within(y, ref.detach(), dtype),
                  "bwd": _norm_within(dx, rdx, dtype)
                  and (dwb[0] - rdw).abs().item()
                  <= NORM_F32_REL * xh_abs.sum().item()
                  and (dwb[1] - rdb).abs().item()
                  <= NORM_F32_REL * g.float().abs().sum().item()}
            check(repeat, f"volume_norm repeat {dtype} at {shape}")
            check(ok["fwd"] and ok["bwd"],
                  f"volume_norm against plain {dtype} at {shape}: {ok}")
            xl = x.detach().requires_grad_(True)
            lib_out = F.group_norm(xl, 1)
            calls = {
                "fwd": (lambda: norm_mod.volume_norm_fwd(x, w, b, NORM_EPS),
                        lambda: norm_mod.volume_instance_norm_reference(
                            x, w, b, NORM_EPS),
                        lambda: F.group_norm(x, 1)),
                "bwd": (lambda: norm_mod.volume_norm_bwd(x, g, w, stats),
                        lambda: torch.autograd.grad(
                            ref, (xr, wr, br), g, retain_graph=True),
                        lambda: torch.autograd.grad(
                            lib_out, xl, g, retain_graph=True))}
            nbytes = x.numel() * x.element_size()
            for d, (kernel, plain, library) in calls.items():
                # least bytes: x read and y written; x and g read and dx
                # written. Operations a pass: the sums (an add and an FMA),
                # then a subtract, two multiplies and an add; backward five
                # and six
                res = {"ms": time_cuda(kernel, 20, flush),
                       "plain_ms": time_cuda(plain, 3, flush),
                       "library_ms": time_cuda(library, 3, flush),
                       **_least_time((2 if d == "fwd" else 3) * nbytes,
                                (6 if d == "fwd" else 11) * x.numel())}
                emit({"phase": "kernel", "name": f"volume_norm_{d}",
                      "dtype": dname, "dataset": dataset,
                      "shape": dict(zip("NCHW", shape)),
                      "layout": "channels_last", "within_limits": ok[d],
                      "repeatable": repeat, "max_abs_err": errs[d], **res})
                m = sums[d]
                m["max_abs_err"] = max(m["max_abs_err"], errs[d])
                if dtype == torch.bfloat16 and dataset == "fasion":
                    _add(m, res)
                    m["library_ms"] = m.get("library_ms", 0.0) \
                        + res["library_ms"]
            del x, g, y, y2, dx, dx2, xr, ref, rdx, xl, lib_out, calls
            torch.cuda.empty_cache()
    return sums["fwd"], sums["bwd"]


def _taps_calls(feats, warps, masks, static_empty, image):
    """The stage's warp_taps calls: [(name, (N, P, 8) coefficients, the
    transforms, y0, x0, s_y, s_x, joint)], the windows' where the stage is
    windowable, then the full map's."""
    n, h, w, _ = feats.shape
    calls = []
    if warp_mod._windowable(h, w):
        _, sel, y0, x0, s_y, s_x = bench_fold._windows(feats, warps, masks,
                                                       static_empty)
        calls.append(("windows", warps[:, sel], y0[:, sel], x0[:, sel], s_y,
                      s_x, True))
    zero = torch.zeros((n, 1), dtype=torch.int64, device=feats.device)
    calls.append(("full", warps[:, :1], zero, zero, h, w, False))
    return [(name, warp_mod._tap_coeffs(wp, h, w, image, y0, x0), wp, y0,
             x0, s_y, s_x, joint)
            for name, wp, y0, x0, s_y, s_x, joint in calls]


def _check_taps(image, pose_dim, stage, dataset, main, flush) -> None:
    """warp_taps and warp_taps_t at one fold stage of a benchmark cell, at
    TAPS_BATCH, bf16 and f32, on a real batch's transforms and windows:
    the forward bitwise its plain version and within TAPS_REL of the
    banded products, the transpose within TAPS_T_REL of its plain version;
    ms (inputs cold), plain ms and bound per launch."""
    static = static_empty_parts(pose_dim)
    feats32, warps, masks = bench_fold._fold_inputs(
        TAPS_BATCH, image, pose_dim, stage, torch.float32,
        torch.device("cuda"))
    n, h, w, c = feats32.shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(stage)
    for dtype, bits in ((torch.bfloat16, torch.int16),
                        (torch.float32, torch.int32)):
        dname = str(dtype).split(".")[-1]
        feats, wd = feats32.to(dtype), warps.to(dtype)
        item = feats.element_size()
        for name, co, wp, y0, x0, s_y, s_x, joint in _taps_calls(
                feats, wd, masks.to(dtype), static, image):
            p = co.shape[1]
            shape = {"N": n, "H": h, "W": w, "C": c, "P": p, "SY": s_y,
                     "SX": s_x}
            win = n * p * s_y * s_x * c
            out = warp_fused.warp_taps(feats, co, s_y, s_x)
            ref = warp_fused.warp_taps_reference(feats, co, s_y, s_x)
            banded = warp_mod._warp_win_banded(feats, wp, y0, x0, s_y, s_x,
                                               image)
            torch.cuda.synchronize()
            same = torch.equal(out.view(bits), ref.view(bits))
            err = (out.float() - ref.float()).abs().max().item()
            scale = banded.float().abs().max().item()
            banded_err = (out.float() - banded.float()).abs().max().item()
            del ref, banded
            ms = time_cuda(lambda: warp_fused.warp_taps(feats, co, s_y, s_x),
                           20, flush)
            plain_ms = time_cuda(lambda: warp_fused.warp_taps_reference(
                feats, co, s_y, s_x), 3, flush)
            res = {"ms": ms, "plain_ms": plain_ms, **_least_time(
                item * (n * h * w * c + win) + 32 * n * p, TAPS_OPS * win)}
            emit({"phase": "kernel", "name": "warp_taps", "dtype": dname,
                  "dataset": dataset, "call": name, "shape": shape,
                  "bitwise_equal": same, "max_abs_err": err,
                  "banded_max_abs_diff": banded_err, "banded_scale": scale,
                  "banded_tol": TAPS_REL[dtype] * scale, **res})
            check(same, f"warp_taps bitwise {dtype} {name} at {h}x{w}x{c}")
            check(scale > 0 and banded_err <= TAPS_REL[dtype] * scale,
                  f"warp_taps vs banded {dtype} {name} at {h}x{w}x{c}: "
                  f"{banded_err} of {scale}")
            _taps_summary(main["warp_taps"], res, err, dtype, dataset)
            del out

            g = torch.randn((n, p, s_y, s_x, c), generator=gen,
                            device="cuda").to(dtype)
            df = warp_fused.warp_taps_t(g, co, h, w, joint)
            ref = warp_fused.warp_taps_t_reference(g, co, h, w, joint)
            again = warp_fused.warp_taps_t(g, co, h, w, joint)
            torch.cuda.synchronize()
            err = (df.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = TAPS_T_REL[dtype] * scale
            deterministic = torch.equal(df, again)
            del ref, again
            ms = time_cuda(lambda: warp_fused.warp_taps_t(g, co, h, w, joint),
                           20, flush)
            plain_ms = time_cuda(lambda: warp_fused.warp_taps_t_reference(
                g, co, h, w, joint), 3, flush)
            out_item = 4 if joint else item
            res = {"ms": ms, "plain_ms": plain_ms, **_least_time(
                item * win + out_item * n * h * w * c + 32 * n * p,
                TAPS_OPS * win)}
            emit({"phase": "kernel", "name": "warp_taps_t", "dtype": dname,
                  "dataset": dataset, "call": name, "joint": joint,
                  "shape": shape, "max_abs_err": err, "scale": scale,
                  "tol": tol, "deterministic": deterministic, **res})
            check(scale > 0 and err <= tol,
                  f"warp_taps_t {dtype} {name} at {h}x{w}x{c}: {err} > {tol}")
            check(deterministic, f"warp_taps_t {dtype} {name} at {h}x{w}x{c} "
                  "differs between two calls")
            _taps_summary(main["warp_taps_t"], res, err, dtype, dataset)
            del df, g


def _taps_summary(m: dict, res: dict, err: float, dtype, dataset) -> None:
    """The kernels line's warp_taps(_t) entry: the largest error of every
    call, the times and bounds summed over fashion's bf16 calls."""
    m["max_abs_err"] = max(m["max_abs_err"], err)
    if dtype == torch.bfloat16 and dataset == "fasion":
        _add(m, res)


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
           **_least_time(nbytes, 2 * BATCH * STREAM_PG * sy * sx * c)}
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
        res = {"ms": ms["current"], "plain_ms": plain_ms, **_least_time(
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
    res = {"ms": ms["current"], "plain_ms": plain_ms, **_least_time(
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
    reset_launch_counts()
    warp_mod.COUNTS["scan_fallback"] = 0


def _counts() -> dict:
    return {**launch_counts(),
            "scan_fallback": warp_mod.COUNTS["scan_fallback"]}


def phase_serve(card: str, backend: str = "matmul") -> dict:
    """The full-width generator on the warp ``backend`` behind
    PoseTransferServer: a warm-up batch, two full batches of 8 and a padded
    partial batch of 3, outputs checked, fold kernel launches counted per
    forward; then one full batch held against a reference path with the
    same weights and inputs, in bf16 and f32: on 'matmul' the kernel-placed
    fold against the plain full-scan fold, on 'pallas' the fused fold
    against the 'matmul' backend."""
    cfg = _fashion(backend)
    gen = build_models(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in gen.parameters())
    check(n_params == GEN_PARAMS, f"generator has {n_params} parameters")
    check(gen.folds.windowed, "auto rule turns the windowed fold on on "
          "CUDA")
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
    taps = PER_FORWARD[backend]["warp_taps"] * forwards \
        + TAPS_PER_FALLBACK * fallbacks
    check(counts["warp_taps"] == taps and counts["warp_taps_t"] == 0,
          f"{counts['warp_taps']} warp_taps launches != {taps}, or "
          f"{counts['warp_taps_t']} warp_taps_t in serving")
    check(counts["volume_norm_fwd"] == GEN_NORMS * forwards
          and counts["volume_norm_bwd"] == 0,
          f"{counts['volume_norm_fwd']} volume_norm_fwd launches != "
          f"{GEN_NORMS} per forward ({forwards} forwards), or "
          f"{counts['volume_norm_bwd']} volume_norm_bwd in serving")
    if backend == "pallas":
        check(counts["warp_fold"] == 2 * forwards
              and counts["warp_fold_idx"] == 0,
              f"{counts['warp_fold']} warp_fold launches != 2 per forward "
              f"({forwards} forwards), or some emitted the argmax")
    emit({"phase": "serve", "backend": backend, "requests": 2 * BATCH + 3,
          "forwards": forwards, "fold_place_launches": place,
          "warp_fold_launches": counts["warp_fold"],
          "warp_taps_launches": counts["warp_taps"],
          "volume_norm_fwd_launches": counts["volume_norm_fwd"],
          "scan_fallbacks": fallbacks,
          "fold_place_per_forward": place / forwards,
          "warp_fold_per_forward": counts["warp_fold"] / forwards,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    # one burst of 16 requests: a check that the server answers, not a
    # serving benchmark (tools/profile_serve.py measures under load)
    emit({"phase": "serve_smoke_stats", "backend": backend, "batch": BATCH,
          "dtype": "bfloat16", "card": card, **stats})

    if backend == "matmul":
        ref, kernel, per_forward = {"windowed": False}, "fold_place", 3
        phase = "kernel_vs_plain_fold"
    else:
        ref, kernel, per_forward = {"backend": "matmul"}, "warp_fold", 2
        phase = "pallas_vs_matmul_backend"
    under_test = gen.folds
    for dtype in (torch.bfloat16, torch.float32):
        gen.dtype = dtype
        step = make_eval_step(dataclasses.replace(cfg, compute_dtype=dtype),
                              gen)
        _reset_counts()
        out_k, _ = step(batch)
        one = _counts()
        check(one["warp_taps"] > 0, f"no warp_taps launch in {phase}")
        # the reference side's warps on the banded products, so that the
        # tap kernel is not on both sides
        gen.folds = dataclasses.replace(under_test, **ref)
        with warp_mod.banded_warps():
            out_p, _ = step(batch)
        gen.folds = under_test
        check(_counts()["warp_taps"] == one["warp_taps"],
              f"warp_taps launched on {phase}'s reference side")
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


def _fashion(backend="matmul", **kw) -> GANConfig:
    return GANConfig(image_size=(256, 256), pose_dim=18, batch_size=BATCH,
                     compute_dtype=torch.bfloat16, warp_backend=backend, **kw)


def _steps(cfg: GANConfig, steps: int, seed: int, on_timed=None) -> dict:
    """``create_state`` and ``make_train_step`` for ``cfg``: one warm-up
    and ``steps`` steps on synthetic batches, the fold kernels counted over
    the timed steps (``on_timed()`` is called where the counts are zeroed).
    Checks the losses finite and every parameter of both nets moved;
    returns the state, the last step's output and gen batch, and the
    readings."""
    state = create_state(cfg, seed=0, device="cuda")
    step = make_train_step(cfg, state)
    rng = np.random.default_rng(seed)

    def draw():
        return synthetic_compact_batch(rng, cfg.batch_size, cfg.image_size,
                                       cfg.pose_dim, gen_type=cfg.gen_type,
                                       num_stacks=cfg.num_stacks)

    batches = [(_stacked(draw()), _stacked(draw()), draw())
               for _ in range(steps + 1)]
    step(*batches[0])                                   # warm-up
    torch.cuda.synchronize()
    nets = (*state.gen.parameters(), *state.disc.parameters())
    before = [p.detach().clone() for p in nets]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    if on_timed is not None:
        on_timed()
    t0 = time.perf_counter()
    results = [step(*b) for b in batches[1:]]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _counts()
    rows = {k: torch.stack([m[k] for m, _ in results]).tolist()
            for k in ("gen", "disc")}
    check(all(np.isfinite(rows[k]).all() for k in rows), f"losses {rows}")
    unmoved = sum(torch.equal(a, b.detach()) for a, b in zip(before, nets))
    check(unmoved == 0, f"{unmoved} parameter tensors did not move")
    return {"state": state, "out": results[-1][1], "gen_batch":
            batches[-1][2], "counts": counts, "rows": rows,
            "step_ms": wall_s / steps * 1e3,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def _check_step_launches(counts: dict, backend: str, steps: int,
                         stacks: int, what: str) -> None:
    """Every fold kernel's launches are ``stacks`` x a baseline step's, a
    scan fallback standing in for a fold_place launch; the norm kernels'
    as GEN_NORMS and DISC_NORMS count them."""
    want = {k: v * steps * stacks for k, v in PER_STEP[backend].items()}
    got = {k: counts[k] for k in want}
    fallbacks = counts["scan_fallback"]
    got["fold_place"] += fallbacks
    got["warp_taps"] -= TAPS_PER_FALLBACK * fallbacks
    # the discriminator phase's forwards have no backward
    if 0 <= got["warp_taps_t"] - want["warp_taps_t"] \
            <= TAPS_PER_FALLBACK * fallbacks:
        got["warp_taps_t"] = want["warp_taps_t"]
    check(got == want, f"{what}: launches {got} != {want} "
          f"({fallbacks} fallbacks)")
    check(counts["fold_place"] > 0, f"{what}: no fold_place launch")
    norms = {"volume_norm_fwd": steps * 2 * (stacks * GEN_NORMS + DISC_NORMS),
             "volume_norm_bwd": steps * (stacks * GEN_NORMS + 2 * DISC_NORMS)}
    check({k: counts[k] for k in norms} == norms,
          f"{what}: norm launches {counts} != {norms}")


def phase_train(card: str, backend: str = "matmul") -> dict:
    """Full-width bf16 training steps through the entry points a trainer
    calls: ``create_state`` then ``make_train_step``, on the warp
    ``backend``."""
    cfg = _fashion(backend)
    run = _steps(cfg, TRAIN_STEPS, seed=2)
    state, launches = run["state"], run["counts"]
    n_gen = sum(p.numel() for p in state.gen.parameters())
    n_disc = sum(p.numel() for p in state.disc.parameters())
    check(n_gen == GEN_PARAMS, f"generator has {n_gen} parameters")
    check(n_disc == DISC_PARAMS, f"discriminator has {n_disc} parameters")
    check(state.gen.folds.windowed, "windowed fold on for CUDA training")
    _check_step_launches(launches, backend, TRAIN_STEPS, 1, "train")
    images = BATCH * (2 * cfg.training_ratio + 1)
    emit({"phase": "train", "backend": backend, "card": card, "batch": BATCH,
          "dtype": "bfloat16",
          "steps": TRAIN_STEPS, "gen_params": n_gen, "disc_params": n_disc,
          "losses": {"gen [total, ll, ad]": run["rows"]["gen"],
                     "disc [total, true, fake]": run["rows"]["disc"]},
          "fold_place_launches": launches["fold_place"],
          "fold_place_idx_launches": launches["fold_place_idx"],
          "fold_route_launches": launches["fold_route"],
          "scan_fallbacks": launches["scan_fallback"],
          "warp_fold_launches": launches["warp_fold"],
          "warp_fold_idx_launches": launches["warp_fold_idx"],
          "warp_fold_bwd_launches": launches["warp_fold_bwd"],
          "volume_norm_fwd_launches": launches["volume_norm_fwd"],
          "volume_norm_bwd_launches": launches["volume_norm_bwd"],
          "step_ms": run["step_ms"],
          # 3 steps after one warm-up: a smoke reading, not a benchmark
          # (tools/profile_train.py measures); images per step counted as
          # N·(2·training_ratio + 1), the generator forwards' inputs
          "smoke_train_img_per_s": images / run["step_ms"] * 1e3,
          "peak_mem_gb": run["peak_mem_gb"]})
    return launches


def phase_fold_grad(backend: str = "matmul") -> list:
    """The fold's f32 gradient through the kernels against autograd
    through the plain full-scan fold on the banded warps
    (``ops.warp.banded_warps``), at one real batch's warps and masks
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
            check(plan.branch == "place", f"stage {h}: the real batch does "
                  "not take the windowed fold")
        else:
            check(plan.branch == "pallas", f"stage {h}: not on the fused "
                  "fold")
        _reset_counts()
        fk = f.clone().requires_grad_(True)
        warp_mod.apply_plan(fk, warps, plan, (256, 256)).backward(g)
        torch.cuda.synchronize()
        if backend == "matmul":
            ran = warp_fused.LAUNCHES["fold_route"] == 1 \
                and warp_fused.LAUNCHES["fold_place_idx"] == 1
        else:
            ran = warp_pallas.LAUNCHES["warp_fold_bwd"] == 1 \
                and warp_pallas.LAUNCHES["warp_fold_idx"] == 1
        check(ran, f"stage {h}: the kernel path did not run")
        fp = f.clone().requires_grad_(True)
        with warp_mod.banded_warps():
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
    fold_route) against the plain full scan (its gradient on the banded
    warps), at a real pose_dim-16 batch's
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
        check(plan.branch == "place",
              "the h36m batch does not take the kernel-placed fold at 224²")
        _reset_counts()
        fk = f.clone().requires_grad_(True)
        out_k = warp_mod.apply_plan(fk, warps, plan, H36M)
        out_k.backward(g)
        torch.cuda.synchronize()
        one = _counts()
        check(one["fold_place_idx"] == 1 and one["fold_route"] == 1,
              f"h36m fold kernels {one}")
        fp = f.clone().requires_grad_(True)
        with warp_mod.banded_warps():
            out_p, _ = warp_mod._fold_scan(fp, warps, plan.masks_r, H36M,
                                           "max", static_empty=static,
                                           emit_idx=False)
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
        gen.folds = dataclasses.replace(gen.folds, backend="matmul")
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


def _time_grad(fn, x, y, iters=5) -> tuple[float, float]:
    """(ms, peak GB above the inputs) of ``fn(x, y)`` forward and backward
    in x, CUDA events around each call after a warm-up."""
    def call():
        x.grad = None
        fn(x, y).backward()
    call()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = time_cuda(call, iters)
    return ms, (torch.cuda.max_memory_allocated() - base) / 2**30


def phase_recipe(card: str, flush) -> tuple[dict, dict]:
    """The full_fasion recipe's step at full width on both backends, then
    nn_loss's kernels on the card; returns the kernel launches of the timed
    steps and the nn_loss kernels' summaries for the kernels line."""
    total = {}
    for backend, steps in (("matmul", TRAIN_STEPS), ("pallas", 1)):
        cfg = _fashion(backend, **RECIPE)
        run = _steps(cfg, steps, seed=8)
        st = run["state"]
        check(st.vgg is not None and not any(
            p.requires_grad for p in st.vgg.parameters()),
            "the state's VGG19 is missing or not frozen")
        _check_step_launches(run["counts"], backend, steps, 1,
                             f"recipe {backend}")
        check(run["counts"]["nn_loss_fwd"] == steps
              and run["counts"]["nn_loss_bwd"] == steps,
              f"recipe {backend}: nn_loss launches {run['counts']}")
        emit({"phase": "recipe", "backend": backend, "card": card,
              "batch": BATCH, "dtype": "bfloat16", "steps": steps, **RECIPE,
              "losses": {"gen [total, ll, ad]": run["rows"]["gen"],
                         "disc [total, true, fake]": run["rows"]["disc"]},
              "launches": {k: run["counts"][k] for k in
                           (*PER_STEP[backend], *nn_loss_mod.LAUNCHES)},
              "scan_fallbacks": run["counts"]["scan_fallback"],
              "step_ms": run["step_ms"], "peak_mem_gb": run["peak_mem_gb"]})
        for k, v in run["counts"].items():
            total[k] = total.get(k, 0) + v
        if backend == "matmul":
            nn_case = (st.vgg, run["out"], run["gen_batch"], cfg)
        del st, run
    _check_nn_loss(*nn_case)
    # the kernels' own check and timing: not the main path's launches
    return total, _nn_loss_kernels(*nn_case, flush)


class _PlainNNLoss(torch.autograd.Function):
    """``NNLoss`` on its plain code (``_forward_plain``,
    ``_backward_plain``), which CUDA tensors no longer take: the oracle
    the kernels are held to."""

    @staticmethod
    def forward(ctx, p, t, nh, nw):
        loss, idx = nn_loss_mod._forward_plain(p, t, nh, nw)
        ctx.save_for_backward(p, t, idx)
        ctx.area = (nh, nw)
        return loss

    @staticmethod
    def backward(ctx, g):
        p, t, idx = ctx.saved_tensors
        d_pred, _ = nn_loss_mod._backward_plain(p, t, idx, g, *ctx.area,
                                                False)
        return d_pred, None, None, None


def _content_features(vgg, out_gen, gen_batch, cfg, copies=1):
    """The generated and target images' content features (f32, NHWC),
    the batch repeated ``copies`` times with a little noise added to
    every copy after the first, so that no two rows are equal."""
    prep = batch_preparer(cfg, "cuda")
    layer = vgg_mod.get_layer_ind(cfg.content_loss_layer)
    gen = torch.Generator(device="cuda").manual_seed(17)
    with torch.no_grad():
        target = prep(gen_batch)["target"].float()
        images = [out_gen.float(), target]
        if copies > 1:
            images = [torch.cat([x] + [
                (x + 0.02 * torch.randn(x.shape, generator=gen,
                                        device="cuda")).clamp(-1.0, 1.0)
                for _ in range(copies - 1)]) for x in images]
        return tuple(vgg_mod.extract_features(vgg, x, layer).contiguous()
                     for x in images)


def _check_nn_loss(vgg, out_gen, gen_batch, cfg) -> None:
    """nn_loss's plain routed code (area 5) at a step's own block1_conv2
    features (f32, N = 8, 256², 64 channels): its gradient of the
    generated image's features against autograd through the plain
    primal, bit for bit at every pixel whose minimum one shift alone
    reaches (at a tie autograd splits the cotangent, the routed backward
    sends it to the first shift: both valid subgradients), and at every
    pixel against −sign(ref − pred) of the first shift that reaches the
    minimum, scaled by 1/(N·H·W); the share of tied pixels; both
    versions' forward-and-backward times and peak memory. The kernels are
    held to this code in ``_nn_loss_kernels``."""
    f_gen, f_tgt = _content_features(vgg, out_gen, gen_batch, cfg)
    a = cfg.nn_loss_area_size
    grads, times = {}, {}
    for name, fn in (("function", _PlainNNLoss.apply),
                     ("plain", nn_loss_mod.nn_loss_reference)):
        x = f_gen.clone().requires_grad_(True)
        val = fn(x, f_tgt, a, a)
        val.backward()
        grads[name] = (val.item(), x.grad)
        times[name] = _time_grad(lambda p, q, fn=fn: fn(p, q, a, a), x,
                                 f_tgt)
    with torch.no_grad():
        pad = nn_loss_mod._pad_gt(f_tgt, a, a)
        n, h, w, _ = f_gen.shape
        shifts = [(i, j) for i in range(a) for j in range(a)]
        norms = torch.stack([(pad[:, i:i + h, j:j + w] - f_gen).abs()
                             .sum(-1) for i, j in shifts])
        at_min = norms == norms.min(0).values
        unique = at_min.sum(0) == 1
        first = at_min.to(torch.uint8).argmax(0)    # the first maximum
        rule = torch.zeros_like(f_gen)
        for k, (i, j) in enumerate(shifts):
            rule = torch.where((first == k)[..., None],
                               -torch.sign(pad[:, i:i + h, j:j + w] - f_gen),
                               rule)
        rule = rule / (n * h * w)
    (v_fn, g_fn), (v_plain, g_plain) = grads["function"], grads["plain"]
    differ = (g_fn != g_plain).any(-1)
    res = {"phase": "nn_loss_plain_vs_autograd", "shape": list(f_gen.shape),
           "dtype": str(f_gen.dtype).split(".")[-1], "area": a,
           "value": v_fn, "value_plain": v_plain,
           "tied_pixel_share": 1.0 - unique.float().mean().item(),
           "pixels_differing": int(differ.sum().item()),
           "pixels_differing_untied": int((differ & unique).sum().item()),
           "pixels_off_first_shift_rule": int((g_fn != rule).any(-1).sum()
                                              .item()),
           "ms": times["function"][0], "plain_ms": times["plain"][0],
           "peak_gb": times["function"][1],
           "plain_peak_gb": times["plain"][1]}
    emit(res)
    check(v_fn == v_plain, "nn_loss value differs from its plain primal")
    check(f_gen.dtype == torch.float32, "content features not f32")
    check(res["pixels_differing_untied"] == 0,
          "nn_loss gradient differs from autograd where the min is unique")
    check(res["pixels_off_first_shift_rule"] == 0,
          "nn_loss gradient does not route to the first minimal shift")


# the nn_loss kernels against the plain code: the loss to f32 rounding
# (the channels and the mean sum in another order), the index equal on
# NN_INDEX_SHARE of the pixels and elsewhere a near tie (the two shifts'
# plain norms within NN_TIE_ULPS ulps of the larger), the cotangent bit for
# bit where the index agrees; at the benchmark cell's shape
NN_LOSS_RTOL, NN_INDEX_SHARE, NN_TIE_ULPS = 1e-6, 0.9999, 4
NN_CELL_COPIES = 4            # b32 from the recipe's b8 step


def _nn_reached(idx, a) -> int:
    """The target pixels inside the map that some pixel's saved shift
    reads."""
    n, h, w = idx.shape
    k = idx.long()
    gy = torch.arange(h, device=idx.device)[:, None] + k // a - a // 2
    gx = torch.arange(w, device=idx.device)[None, :] + k % a - a // 2
    inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    flat = (torch.arange(n, device=idx.device)[:, None, None] * h + gy) \
        * w + gx
    return int(torch.unique(flat[inside]).numel())


def _nn_loss_kernels(vgg, out_gen, gen_batch, cfg, flush) -> dict:
    """The forward and backward kernels against the plain code at the
    benchmark cell's shape (N = 32, 256²×64 f32, area 5, the features of
    the recipe step's images), each launch's time with a cold L2, the
    plain code's, and the least time of its bytes and operations
    (``nn_loss_bytes``, ``nn_loss_ops``; the backward's bytes count the
    target pixels its index reaches, ``shape_bound_ms`` none of them, as
    the benchmark's shape-only roofline counts them)."""
    f_gen, f_tgt = _content_features(vgg, out_gen, gen_batch, cfg,
                                     NN_CELL_COPIES)
    a = cfg.nn_loss_area_size
    n, h, w, c = f_gen.shape
    one = torch.ones((), device="cuda")
    scale = one / (n * h * w)
    loss, idx = nn_loss_mod.nn_loss_fwd(f_gen, f_tgt, a, a)
    d_pred = nn_loss_mod.nn_loss_bwd(f_gen, f_tgt, idx, scale, a, a)
    again = nn_loss_mod.nn_loss_fwd(f_gen, f_tgt, a, a)
    want, want_idx = nn_loss_mod._forward_plain(f_gen, f_tgt, a, a)
    want_d, _ = nn_loss_mod._backward_plain(f_gen, f_tgt, want_idx, one, a,
                                            a, False)
    same = idx == want_idx
    with torch.no_grad():
        pad = nn_loss_mod._pad_gt(f_tgt, a, a)
        k_got, k_want = idx[~same].long(), want_idx[~same].long()
        rows = torch.nonzero(~same)
        worst_ulps = 0.0
        if len(rows):
            def norm_at(k):
                i, j = k // a, k % a
                nn_, yy, xx = rows.unbind(1)
                return (pad[nn_, yy + i, xx + j] - f_gen[nn_, yy, xx]) \
                    .abs().sum(-1)
            na, nb = norm_at(k_got), norm_at(k_want)
            worst_ulps = ((na - nb).abs() / (torch.maximum(na, nb)
                                             * 2.0 ** -23)).max().item()
    rel = abs(loss.item() - want.item()) / abs(want.item())
    bits_equal = bool(torch.equal(d_pred[same], want_d[same]))
    # each kernel's largest |kernel − plain| over its float output: the
    # forward's one loss; the backward's every element, those of the
    # pixels whose index differs included
    errs = {"fwd": abs(loss.item() - want.item()),
            "bwd": (d_pred - want_d).abs().max().item()}
    reached = _nn_reached(idx, a)
    iters = 5
    out = {}
    for direction, kernel, plain in (
            ("fwd", lambda: nn_loss_mod.nn_loss_fwd(f_gen, f_tgt, a, a),
             lambda: nn_loss_mod._forward_plain(f_gen, f_tgt, a, a)),
            ("bwd", lambda: nn_loss_mod.nn_loss_bwd(f_gen, f_tgt, idx, scale,
                                                    a, a),
             lambda: nn_loss_mod._backward_plain(f_gen, f_tgt, want_idx, one,
                                                 a, a, False))):
        ops = nn_loss_ops(n, h, w, c, a, direction)
        bound = _least_time(nn_loss_bytes(n, h, w, c, direction, reached), ops)
        shape_ms = _least_time(nn_loss_bytes(n, h, w, c, direction), ops)[
            "bound_ms"]
        ms = time_cuda(kernel, iters, flush)
        out[f"nn_loss_{direction}"] = {
            "ms": ms, "plain_ms": time_cuda(plain, iters, flush),
            "max_abs_err": errs[direction],
            "roofline_pct": 100.0 * bound["bound_ms"] / ms,
            "shape_bound_ms": shape_ms, **bound}
    emit({"phase": "nn_loss_kernels", "shape": [n, h, w, c], "area": a,
          "value": loss.item(), "value_plain": want.item(),
          "value_rel_err": rel, "value_abs_err": errs["fwd"],
          "cotangent_max_abs_err": errs["bwd"],
          "index_equal_share": same.float().mean().item(),
          "index_differing": int((~same).sum().item()),
          "index_differing_worst_ulps": worst_ulps,
          "target_pixels_reached_share": reached / (n * h * w),
          "cotangent_bits_equal_where_index_agrees": bits_equal,
          "repeat_bitwise": bool(torch.equal(loss, again[0])
                                 and torch.equal(idx, again[1])),
          **{k: {m: v[m] for m in ("ms", "plain_ms", "bound_ms", "bytes_ms",
                                   "ops_ms", "bound_by", "roofline_pct",
                                   "shape_bound_ms")}
             for k, v in out.items()}})
    check(rel <= NN_LOSS_RTOL, f"nn_loss kernel value off by {rel}")
    check(same.float().mean().item() >= NN_INDEX_SHARE,
          "nn_loss kernel index differs on too many pixels")
    check(worst_ulps <= NN_TIE_ULPS,
          f"nn_loss kernel index differs off a near tie ({worst_ulps} ulps)")
    check(bits_equal, "nn_loss kernel cotangent differs where the index "
          "agrees")
    check(bool(torch.equal(loss, again[0]) and torch.equal(idx, again[1])),
          "nn_loss kernel not repeatable")
    return out


def phase_stacked(card: str) -> dict:
    """The stacked generator behind the server on both backends (a full
    and a padded partial batch), 'pallas' held to 'matmul' stage by stage,
    then stacked train steps on 'matmul'; returns the fold kernel
    launches."""
    cfg = _fashion(gen_type="stacked", num_stacks=NUM_STACKS)
    gen = build_models(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in gen.parameters())
    check(n_params == GEN_PARAMS, f"stacked generator has {n_params} "
          "parameters (one shared generator)")
    reqs = make_requests(np.random.default_rng(9), BATCH + 3, (256, 256))
    total, full = {}, {}
    for backend in ("matmul", "pallas"):
        gen.generator.folds = dataclasses.replace(gen.generator.folds,
                                                  backend=backend)
        bcfg = dataclasses.replace(cfg, warp_backend=backend)
        torch.cuda.reset_peak_memory_stats()
        with PoseTransferServer(bcfg, gen, max_wait_ms=200.0) as srv:
            check_images(srv.generate(reqs[:BATCH]), BATCH, "warm-up")
            srv.reset_stats()
            _reset_counts()
            full[backend] = srv.generate(reqs[:BATCH])
            partial = srv.generate(reqs[BATCH:])
            counts = _counts()
            stats = srv.stats()
            batch = collate([srv.prepare_request(*r) for r in reqs[:BATCH]])
        check_images(full[backend], BATCH, f"stacked {backend} full batch")
        check_images(partial, 3, f"stacked {backend} partial batch")
        forwards = stats["batches"]
        per = PER_FORWARD[backend]
        got = {"fold_place": counts["fold_place"] + counts["scan_fallback"],
               "warp_fold": counts["warp_fold"],
               "warp_taps": counts["warp_taps"]
               - TAPS_PER_FALLBACK * counts["scan_fallback"]}
        want = {k: NUM_STACKS * v * forwards for k, v in per.items()}
        check(forwards == 2 and got == want
              and counts["warp_fold_idx"] == counts["fold_place_idx"] == 0,
              f"stacked {backend}: {forwards} forwards, launches {got} != "
              f"{want}")
        emit({"phase": "stacked_serve", "backend": backend, "card": card,
              "num_stacks": NUM_STACKS, "forwards": forwards,
              "fold_place_per_forward": counts["fold_place"] / forwards,
              "warp_fold_per_forward": counts["warp_fold"] / forwards,
              "scan_fallbacks": counts["scan_fallback"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
              **stats})
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    # the backends stage by stage: each 'pallas' stage is fed the 'matmul'
    # stage's own input and held to the serving limits of one forward
    # (BF16_MAX_ABS, BF16_MEAN_ABS). The served images are 4 chained bf16
    # generators, each carrying the last one's single-ulp flips into its
    # input, so their difference is reported beside, not held to those
    # limits
    calls = []
    hook = gen.generator.register_forward_hook(
        lambda m, args, out: calls.append((args, out)))
    gen.generator.folds = dataclasses.replace(gen.generator.folds,
                                              backend="matmul")
    try:
        make_eval_step(cfg, gen)(batch)
    finally:
        hook.remove()
    gen.generator.folds = dataclasses.replace(gen.generator.folds,
                                              backend="pallas")
    stages = []
    with torch.inference_mode():
        for args, ref in calls:
            d = (gen.generator(*args).float() - ref.float()).abs()
            stages.append([d.max().item(), d.mean().item()])
    served = np.abs(full["pallas"] - full["matmul"])
    emit({"phase": "stacked_pallas_vs_matmul", "dtype": "bfloat16",
          "stage_max_mean_abs_diff": stages,
          "served_max_abs_diff": float(served.max()),
          "served_mean_abs_diff": float(served.mean())})
    check(len(stages) == NUM_STACKS and all(
        mx <= BF16_MAX_ABS and mean <= BF16_MEAN_ABS for mx, mean in stages),
        f"stacked 'pallas' stages differ from 'matmul': {stages}")
    del gen, calls

    run = _steps(cfg, TRAIN_STEPS, seed=10)
    _check_step_launches(run["counts"], "matmul", TRAIN_STEPS, NUM_STACKS,
                         "stacked train")
    check(tuple(run["out"].shape) == (NUM_STACKS, BATCH, *cfg.image_size, 3),
          f"stacked step output {tuple(run['out'].shape)}")
    emit({"phase": "stacked_train", "backend": "matmul", "card": card,
          "batch": BATCH, "dtype": "bfloat16", "num_stacks": NUM_STACKS,
          "steps": TRAIN_STEPS,
          "losses": {"gen [total, ll, ad]": run["rows"]["gen"],
                     "disc [total, true, fake]": run["rows"]["disc"]},
          "launches": {k: run["counts"][k] for k in PER_STEP["matmul"]},
          "scan_fallbacks": run["counts"]["scan_fallback"],
          "step_ms": run["step_ms"], "peak_mem_gb": run["peak_mem_gb"]})
    for k, v in run["counts"].items():
        total[k] += v
    return total


def phase_unet(card: str) -> None:
    """The U-Net behind the server: one batch of 8, no fold kernel; one
    volume_norm_fwd launch for each of its GEN_NORMS - 5 normed Blocks
    (one encoder of 5, the decoder's 6)."""
    cfg = _fashion(gen_type="unet")
    gen = build_models(cfg, seed=0, device="cuda")
    reqs = make_requests(np.random.default_rng(11), BATCH, (256, 256))
    with PoseTransferServer(cfg, gen, max_wait_ms=200.0) as srv:
        _reset_counts()
        out = srv.generate(reqs)
        counts = _counts()
    check_images(out, BATCH, "unet batch")
    norms = {"volume_norm_fwd": GEN_NORMS - 5, "volume_norm_bwd": 0}
    check({k: counts[k] for k in norms} == norms
          and not any(v for k, v in counts.items() if k not in norms),
          f"the U-Net launched {counts}")
    emit({"phase": "unet_serve", "card": card, "batch": BATCH,
          "gen_params": sum(p.numel() for p in gen.parameters()),
          "launches": counts})


def phase_cli_recipe(card: str) -> dict:
    """The CLIs at full width on fashion: the full_fasion content-loss run,
    the stacked run warm-started from it, test and evaluate; returns the
    fold kernel launches of the two training runs."""
    tmp = tempfile.TemporaryDirectory(prefix="cli_recipe_")
    root = Path(tmp.name)
    data = str(root / "data") + "/"
    flags = ["--data_Dir", data, "--dataset", "fasion", "--pose_dim", "18",
             "--compute_dtype", "bfloat16", "--batch_size", str(BATCH),
             "--iters_per_epoch", str(CLI_ITERS), "--number_of_epochs", "1",
             "--checkpoint_ratio", "1", "--display_ratio", "2",
             "--checkMode", "0", "--exp_root", str(root / "exp"),
             "--device", "cuda"]
    _, secs = _cli(cli_data.main, ["--out", data, "--dataset", "fasion",
                                   "--pose_dim", "18"])
    emit({"phase": "cli_recipe", "step": "make_synthetic_data",
          "seconds": secs})
    recipe = ["--content_loss_layer", RECIPE["content_loss_layer"],
              "--nn_loss_area_size", str(RECIPE["nn_loss_area_size"]),
              "--l1_penalty_weight", str(RECIPE["l1_penalty_weight"])]
    stacked = ["--expID", "stacked", "--gen_type", "stacked",
               "--num_stacks", str(NUM_STACKS)]
    warm = root / "exp" / "full_fasion" / "models" / "gen_001.pt"
    total = {}
    for run, extra in (("full_fasion", ["--expID", "full_fasion", *recipe]),
                       ("stacked", stacked)):
        _reset_counts()
        out, secs = _cli(cli_main.main, flags + extra)
        counts = _counts()
        exp = root / "exp" / run
        rows = [json.loads(ln) for ln in
                (exp / "metrics.jsonl").read_text().splitlines()]
        check(len(rows) == 2 and all(
            math.isfinite(v) for r in rows for k, v in r.items()
            if k not in ("epoch", "it")), f"{run}: losses {rows}")
        check((exp / "models" / "gen_001.pt").exists(),
              f"{run}: no checkpoint")
        if run == "stacked":
            check(f"Warm-started stacked generator from {warm}" in out,
                  "the stacked run did not warm-start")
        check(counts["fold_place"] > 0 and counts["fold_route"] > 0,
              f"{run}: launches {counts}")
        emit({"phase": "cli_recipe", "step": f"main_{run}", "card": card,
              "seconds": secs, "batch": BATCH, "dtype": "bfloat16",
              "cli_img_per_s": _img_per_s(out),
              "losses": [{k: r[k] for k in ("it", "gen_total", "gen_ll",
                                            "disc_total")} for r in rows],
              "fold_place_launches": counts["fold_place"],
              "fold_place_idx_launches": counts["fold_place_idx"],
              "fold_route_launches": counts["fold_route"],
              "scan_fallbacks": counts["scan_fallback"]})
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    exp = root / "exp" / "stacked"
    out, secs = _cli(cli_test.main, flags + stacked + ["--resume", "1"])
    grids = sorted((exp / "results" / "generated").iterdir())
    # 4 people x 3 images: 24 ordered test pairs, 3 batches of 8
    shapes = {read_image(str(g)).shape for g in grids}
    check("epoch-1 weights" in out and len(grids) == 24 // BATCH
          and shapes == {(BATCH * 256, (2 + 2 * NUM_STACKS) * 256, 3)},
          f"cli.test stacked grids {len(grids)} {shapes}")
    emit({"phase": "cli_recipe", "step": "test", "seconds": secs,
          "grids": len(grids)})
    out, secs = _cli(cli_evaluate.main, flags + stacked + [
        "--resume", "1", "--max_batches", "2"])
    res = json.loads(out.strip().splitlines()[-1])
    check(res["num_batches"] == 2 and all(math.isfinite(res[k]) for k in (
        "value", "l1", "psnr", "feat_l2", "feat_l1", "feat_nn")),
        f"cli.evaluate {res}")
    emit({"phase": "cli_recipe", "step": "evaluate", "seconds": secs,
          "result": res})
    tmp.cleanup()
    return total


# ------------------------------------ HTTP front, JAX files, 'exact', Keras

HTTP_REQUESTS, HTTP_CLIENTS = 384, 16
KERNELS = ("fold_place", "fold_place_idx", "fold_route", "warp_fold",
           "warp_fold_idx", "warp_fold_bwd", "fold_place_stream",
           "warp_taps", "warp_taps_t", "nn_loss_fwd", "nn_loss_bwd")
# warp_feature_single against grid_sample (f64 on a normalized affine
# grid): the same bilinear function, the port's f32 positions rounded. A
# position of magnitude up to 2h carries an error of a few f32 ulps of 2h
# (EXACT_POS_ULPS), and a sample moves by that times the difference of
# neighbouring values in each axis (≤ 2 max|f|). The exact fold against
# the 'matmul' fold where m10 = 0, in f32: the same positions and tap
# weights, the banded products summed in another order: within 1e-5 of the
# largest magnitude (as on the CPU, tests/test_torch_exact.py)
EXACT_POS_ULPS, EXACT_F32_REL = 4, 1e-5


def _u8(x: torch.Tensor) -> np.ndarray:
    """The server's uint8 map of [-1, 1] images."""
    return ((x.float().clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8) \
        .cpu().numpy()


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _http(port, path, body=None):
    """(status, body) of one request to the loopback server."""
    url = f"http://127.0.0.1:{port}{path}"
    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _image_of(body: bytes) -> np.ndarray:
    with np.load(io.BytesIO(body)) as z:
        return z["image"]


def _jax_layout_run(root: Path) -> tuple:
    """A fashion-256 deformable generator and discriminator (bf16 compute,
    seeded) after one training step, written as the JAX package's
    ``gen_001.msgpack``/``disc_001.msgpack`` under ``root/exp/jax/models``
    (the inverse weight map and the msgpack encoder). Returns the state and
    the models directory."""
    cfg = _fashion()
    run = _steps(cfg, 1, seed=21)
    state = run["state"]
    models = root / "exp" / "jax" / "models"
    models.mkdir(parents=True)
    gen_tree, disc_tree = import_flax.train_state_to_flax(state)
    flax_msgpack.save(str(models / "gen_001.msgpack"), gen_tree)
    flax_msgpack.save(str(models / "disc_001.msgpack"), disc_tree)
    return state, models


def _same_state_dict(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def phase_http_serve(card: str, root: Path, state) -> dict:
    """cli.serve at full width: ``build_server --resume 1`` on the JAX-layout
    files, ``make_http_server`` on loopback; 2 full batches and 3 requests
    sent concurrently and held against the eval step, the error paths, then
    HTTP requests/s under 16 client threads beside the same server's
    in-process capacity. Returns the fold kernel launches of the first
    requests."""
    opt = Opts().parse([
        "--expID", "jax", "--dataset", "fasion", "--pose_dim", "18",
        "--batch_size", str(BATCH), "--compute_dtype", "bfloat16",
        "--exp_root", str(root / "exp"), "--resume", "1",
        "--max_wait_ms", "200", "--serve_port", "0", "--device", "cuda"])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        pts = cli_serve.build_server(opt)
    secs, out = time.perf_counter() - t0, buf.getvalue()
    check("Serving epoch-1 weights" in out, f"build_server: {out!r}")
    check(_same_state_dict(pts.gen.state_dict(), state.gen.state_dict()),
          "the served generator is not the one written, bit for bit")
    cli_serve.warm_up(pts, 18)
    httpd = cli_serve.make_http_server(pts, "127.0.0.1", 0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        n_req = 2 * BATCH + 3
        reqs = make_requests(np.random.default_rng(31), n_req, (256, 256))
        bodies = [_npz(image=i, kp_from=a, kp_to=b) for i, a, b in reqs]
        _reset_counts()
        with cf.ThreadPoolExecutor(len(bodies)) as ex:
            answers = list(ex.map(lambda b: _http(port, "/generate", b),
                                  bodies))
        counts = _counts()
        stats = json.loads(_http(port, "/stats")[1])
        check(all(code == 200 for code, _ in answers),
              f"HTTP codes {[c for c, _ in answers]}")
        got = np.stack([_image_of(b) for _, b in answers])
        check(got.dtype == np.uint8 and got.shape == (n_req, 256, 256, 3),
              f"served images {got.dtype} {got.shape}")
        check(stats["served"] == n_req, f"/stats counts {stats['served']}")
        forwards = stats["batches"]
        place, fallbacks = counts["fold_place"], counts["scan_fallback"]
        check(place + fallbacks == 3 * forwards and place > 0,
              f"{place} fold_place + {fallbacks} fallbacks in {forwards} "
              "forwards, not 3 a forward")
        check(_http(port, "/healthz") == (200, b"ok"), "/healthz")
        check(_http(port, "/generate", b"not-npz")[0] == 400,
              "a malformed body is not answered 400")
        img, kp_from, kp_to = reqs[0]
        code, body = _http(port, "/generate", _npz(
            image=img[:128], kp_from=kp_from, kp_to=kp_to))
        check(code == 400 and b"image must be" in body,
              f"a wrong-shape image answered {code} {body[:80]!r}")
        # the eval step's uint8 output for the same requests, 8 at a time:
        # the serving limits on [-1, 1], mapped to the uint8 scale
        step = make_eval_step(pts.config, pts.gen, "cuda")
        samples = [pts.prepare_request(*r) for r in reqs]
        samples += [samples[-1]] * (-n_req % BATCH)
        ref = np.concatenate([
            _u8(step(collate(samples[i:i + BATCH]))[0])
            for i in range(0, len(samples), BATCH)])[:n_req]
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        res = {"max_abs_diff_u8": int(diff.max()),
               "mean_abs_diff_u8": float(diff.mean())}
        check(res["max_abs_diff_u8"] <= math.ceil(127.5 * BF16_MAX_ABS)
              and res["mean_abs_diff_u8"] <= 127.5 * BF16_MEAN_ABS,
              f"HTTP images against the eval step: {res}")
        emit({"phase": "http_serve", "card": card, "batch": BATCH,
              "dtype": "bfloat16", "build_server_s": secs,
              "requests": n_req, "forwards": forwards,
              "fold_place_launches": place, "scan_fallbacks": fallbacks,
              "fold_place_per_forward": place / forwards,
              "vs_eval_step": res, "stats": stats})

        # load: the same 64 seeded requests from 16 client threads over
        # HTTP (npz bodies encoded beforehand), then in process
        rng = np.random.default_rng(32)
        pool = profile_serve.requests(rng, 64, pts.config)
        pool_bodies = [_npz(image=i, kp_from=a, kp_to=b)
                       for i, a, b in pool]

        def client(c):
            codes = []
            for j in range(c, HTTP_REQUESTS, HTTP_CLIENTS):
                code, body = _http(port, "/generate",
                                   pool_bodies[j % len(pool_bodies)])
                codes.append(code)
            return codes

        pts.reset_stats()
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(HTTP_CLIENTS) as ex:
            codes = [c for cs in ex.map(client, range(HTTP_CLIENTS))
                     for c in cs]
        http_s = time.perf_counter() - t0
        http_stats = pts.stats()
        check(codes.count(200) == HTTP_REQUESTS,
              f"{HTTP_REQUESTS - codes.count(200)} HTTP requests failed")
        capacity = profile_serve._serve_load(pts, pool, HTTP_REQUESTS, None,
                                             rng)
        check(capacity["failed"] == 0, "in-process requests failed")
        emit({"phase": "http_serve_load", "card": card, "batch": BATCH,
              "dtype": "bfloat16", "requests": HTTP_REQUESTS,
              "clients": HTTP_CLIENTS,
              "http_req_per_s": HTTP_REQUESTS / http_s,
              "http_latency_p50_ms": http_stats["latency_p50_ms"],
              "http_latency_p95_ms": http_stats["latency_p95_ms"],
              "http_mean_batch_fill": http_stats["mean_batch_fill"],
              "in_process_img_per_s": capacity["img_per_s"],
              "in_process_latency_ms": capacity["latency_ms"],
              "in_process_mean_batch_fill": capacity["mean_batch_fill"]})
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
        pts.close()
    return counts


def phase_resume_msgpack(card: str, root: Path, state) -> dict:
    """cli.main --resume 1 on the JAX-layout files: one epoch of 2
    iterations at b8; resumes at epoch 1 and the file's step with both
    optimizers' Adam state bit for bit the written one's; losses finite;
    writes .pt files. Returns the fold kernel launches of the run."""
    data = str(root / "data") + "/"
    _cli(cli_data.main, ["--out", data, "--dataset", "fasion",
                         "--pose_dim", "18"])
    seen = {}
    real_resume = checkpoint.resume

    def resume(st, save_dir, *a, **k):
        st, epoch = real_resume(st, save_dir, *a, **k)
        seen.update(epoch=epoch, step=st.step, opt=all(
            _same_opt(getattr(st, f"{n}_opt"), getattr(state, f"{n}_opt"))
            for n in ("gen", "disc")), nets=all(
            _same_state_dict(getattr(st, n).state_dict(),
                             getattr(state, n).state_dict())
            for n in ("gen", "disc")))
        return st, epoch

    flags = ["--expID", "jax", "--data_Dir", data, "--dataset", "fasion",
             "--pose_dim", "18", "--compute_dtype", "bfloat16",
             "--batch_size", str(BATCH), "--iters_per_epoch", "2",
             "--number_of_epochs", "1", "--checkpoint_ratio", "1",
             "--display_ratio", "1", "--exp_root", str(root / "exp"),
             "--resume", "1", "--device", "cuda"]
    checkpoint.resume = resume
    _reset_counts()
    try:
        out, secs = _cli(cli_main.main, flags)
    finally:
        checkpoint.resume = real_resume
    counts = _counts()
    check(seen.get("epoch") == 1 and seen.get("step") == state.step,
          f"resumed at {seen}")
    check(seen["nets"] and seen["opt"], "the resumed weights or Adam "
          "states are not the written ones, bit for bit")
    check("rng key does not carry over" in out, "no reseed note")
    exp = root / "exp" / "jax"
    rows = [json.loads(ln) for ln in
            (exp / "metrics.jsonl").read_text().splitlines()]
    check(len(rows) == 2 and all(math.isfinite(v) for r in rows
                                 for k, v in r.items()
                                 if k not in ("epoch", "it")),
          f"losses {rows}")
    saved = torch.load(exp / "models" / "gen_001.pt", weights_only=True)
    check(saved["step"] == state.step + 2, f"saved step {saved['step']}")
    check(counts["fold_place"] > 0 and counts["fold_route"] > 0,
          f"launches {counts}")
    emit({"phase": "resume_msgpack", "card": card, "batch": BATCH,
          "dtype": "bfloat16", "seconds": secs, "resumed": seen,
          "losses": [{k: r[k] for k in ("it", "gen_total", "gen_ll",
                                        "disc_total")} for r in rows],
          "launches": {k: counts[k] for k in KERNELS},
          "scan_fallbacks": counts["scan_fallback"]})
    return counts


def _same_opt(a, b) -> bool:
    """Two Adam optimizers' states equal bit for bit (the step as a
    number: the JAX layout stores it as an int32)."""
    sa, sb = a.state_dict()["state"], b.state_dict()["state"]
    return sa.keys() == sb.keys() and all(
        float(sa[i]["step"]) == float(sb[i]["step"])
        and torch.equal(sa[i]["exp_avg"].cpu(), sb[i]["exp_avg"].cpu())
        and torch.equal(sa[i]["exp_avg_sq"].cpu(),
                        sb[i]["exp_avg_sq"].cpu()) for i in sa)


def phase_exact(card: str) -> None:
    """warp_backend='exact' on the card: warp_feature_single against
    grid_sample and the exact fold against the 'matmul' one (m10 = 0) at
    256²×64 f32; a full-width serving forward and 2 training steps at b8
    bf16, no fold kernel launched, timed beside 'matmul'."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    n, h, c = BATCH, 256, 64
    f = torch.randn((n, h, h, c), generator=gen, device="cuda")
    batch = synthetic_compact_batch(np.random.default_rng(41), n, (h, h), 18)
    warps = torch.as_tensor(batch["warps"], device="cuda")
    got = warp_mod.warp_feature_single(f, warps[:, 1], (h, h))
    m = warps[:, 1].double()
    one = torch.ones_like(m[:, 0])
    theta = torch.stack([
        torch.stack([m[:, 0], m[:, 1], m[:, 0] + m[:, 1]
                     + 2 * m[:, 2] / h - one], 1),
        torch.stack([m[:, 3], m[:, 4], m[:, 3] + m[:, 4]
                     + 2 * m[:, 5] / h - one], 1)], 1)
    grid = F.affine_grid(theta, (n, 1, h, h), align_corners=False)
    want = F.grid_sample(f.double().permute(0, 3, 1, 2), grid,
                         mode="bilinear", padding_mode="zeros",
                         align_corners=False).permute(0, 2, 3, 1)
    gs_err = (got.double() - want).abs().max().item()
    gs_scale = f.abs().max().item()
    gs_tol = 2 * EXACT_POS_ULPS * 2.0 ** -23 * (2 * h) * 2 * gs_scale
    check(gs_err <= gs_tol,
          f"warp_feature_single vs grid_sample {gs_err} > {gs_tol}")

    w0 = warps.clone()
    w0[..., 3] = 0.0
    masks = make_batch_preparer(image_size=(h, h), pose_dim=18,
                                device="cuda")(batch)["masks"]
    _reset_counts()
    exact = warp_mod.affine_transform_layer(f, w0, masks, (h, h),
                                            backend="exact")
    check(not any(_counts().values()), "the exact fold launched a kernel")
    matmul = warp_mod.affine_transform_layer(f, w0, masks, (h, h))
    fold_err = (exact - matmul).abs().max().item()
    fold_scale = matmul.abs().max().item()
    check(fold_err <= EXACT_F32_REL * fold_scale,
          f"exact vs matmul fold at m10 = 0: {fold_err} of {fold_scale}")
    emit({"phase": "exact_ops", "card": card, "shape": [n, h, h, c],
          "dtype": "float32", "vs_grid_sample_max_abs": gs_err,
          "vs_grid_sample_tol": gs_tol, "features_max_abs": gs_scale,
          "vs_matmul_fold_max_abs": fold_err, "vs_matmul_fold_scale":
          fold_scale, "vs_matmul_fold_tol_rel": EXACT_F32_REL})
    del f, got, want, grid, exact, matmul

    for backend in ("matmul", "exact"):
        cfg = _fashion(backend)
        g = build_models(cfg, seed=0, device="cuda")
        step = make_eval_step(cfg, g, "cuda")
        reqs = make_requests(np.random.default_rng(42), BATCH, (256, 256))
        with PoseTransferServer(cfg, g, device="cuda") as srv:
            batch = collate([srv.prepare_request(*r) for r in reqs])
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        out, _ = step(batch)
        fwd_counts = _counts()
        check_images(out.float().cpu().numpy(), BATCH, f"{backend} forward")
        fwd_ms = time_cuda(lambda: step(batch), 5)
        fwd_peak = torch.cuda.max_memory_allocated() / 2**30
        del g, step
        run = _steps(cfg, 2, seed=43)
        if backend == "exact":
            check(not any(fwd_counts[k] for k in KERNELS)
                  and not any(run["counts"][k] for k in KERNELS),
                  f"'exact' launched {fwd_counts} / {run['counts']}")
        emit({"phase": "exact", "backend": backend, "card": card,
              "batch": BATCH, "dtype": "bfloat16",
              "forward_ms": fwd_ms, "forward_peak_mem_gb": fwd_peak,
              "step_ms": run["step_ms"], "steps": 2,
              "step_peak_mem_gb": run["peak_mem_gb"],
              "losses": {"gen [total, ll, ad]": run["rows"]["gen"],
                         "disc [total, true, fake]": run["rows"]["disc"]},
              "launches": {k: run["counts"][k] for k in KERNELS}})
        del run


def _keras_layers(sd: dict, groups: list, rng) -> list:
    """Keras-order weight lists of ``groups`` (a module's weight names per
    Keras layer, in the reference's walk order), in Keras shapes: a conv
    kernel (kh, kw, ·, ·) is the inverse of the reference's [3, 2, 0, 1]
    transpose. Layers without weights in between, drawn from ``rng``."""
    layers = [[]]
    for names in groups:
        ws = []
        for name in names:
            w = sd[name].numpy()
            ws.append(np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
                      if w.ndim == 4 else w)
        layers += [ws, []] if rng.random() < 0.5 else [ws]
    return layers


def _walk_names(sd: dict) -> list:
    """The module's weights grouped per Keras layer, in the walk order of
    ``models.import_keras`` (conv [+ bias], then norm scale + bias)."""
    groups, seen = [], set()
    for name in sd:
        stem = name.rsplit(".", 1)[0]
        if stem in seen:
            continue
        seen.add(stem)
        groups.append([f"{stem}.weight"] + ([f"{stem}.bias"]
                                            if f"{stem}.bias" in sd
                                            else []))
    return groups


def phase_keras(card: str) -> None:
    """The Keras importer at full width: a seeded generator's and
    discriminator's weights as Keras-order layer lists through
    ``import_generator_keras`` / ``import_discriminator_keras`` into fresh
    modules; their forwards finite and bit for bit those of the modules
    the weights came from (no .h5: the card has no h5py)."""
    cfg = _fashion()
    rng = np.random.default_rng(51)
    src = build_models(cfg, seed=5, device="cuda")
    dst = build_models(cfg, seed=6, device="cuda")
    sd = {k: v.cpu() for k, v in src.state_dict().items()}
    n_enc, n_dec = (len(x) for x in cfg.filters)
    layers = _keras_layers(sd, _walk_names(sd), rng)
    dst.load_state_dict(import_keras.import_generator_keras(layers, n_enc,
                                                            n_dec))
    reqs = make_requests(np.random.default_rng(52), BATCH, (256, 256))
    with PoseTransferServer(cfg, src, device="cuda") as srv:
        batch = collate([srv.prepare_request(*r) for r in reqs])
    a = make_eval_step(cfg, src, "cuda")(batch)[0]
    b = make_eval_step(cfg, dst, "cuda")(batch)[0]
    check(bool(torch.isfinite(b).all()) and torch.equal(a, b),
          "the Keras-imported generator's forward differs")

    torch.manual_seed(53)
    disc = Discriminator(cfg.input_nc + 3, dtype=torch.bfloat16,
                         device="cuda")
    disc2 = Discriminator(cfg.input_nc + 3, dtype=torch.bfloat16,
                          device="cuda")
    dsd = {k: v.cpu() for k, v in disc.state_dict().items()}
    disc2.load_state_dict(import_keras.import_discriminator_keras(
        _keras_layers(dsd, _walk_names(dsd), rng)))
    x = torch.randn((BATCH, 256, 256, cfg.input_nc + 3), device="cuda")
    with torch.no_grad():
        da, db = disc(x), disc2(x)
    check(bool(torch.isfinite(db).all()) and torch.equal(da, db),
          "the Keras-imported discriminator's forward differs")
    emit({"phase": "keras", "card": card, "gen_params": sum(
        v.numel() for v in sd.values()), "disc_params": sum(
        v.numel() for v in dsd.values()), "keras_layers": len(layers),
        "forwards_bitwise": True})


# ------------------------------------------ the fold's chunking, data-parallel

# phase 17 (chunked): fashion-256 stage 0, bf16, the kernel-placed fold at
# b32 under the default cap (one call), a 512 MB cap (chunks of 9 and a tail
# of 5) and part groups of 3; the step at b64 (stage 0 chunks 54 + 10 under
# the default 3072 MB: 56.25 MB a sample by JAX's estimate) beside one at
# b32. With part groups, each group's windowed warps and transposed warps
# are separate GEMMs: cuBLAS may tile a smaller GEMM otherwise (a bf16
# rounding of a window element may flip), and the groups' f32 gradients are
# added in group order (the f32 sum reassociates; a bf16 rounding of the
# gradient may flip). So with groups the output is held within one bf16 ulp
# of each element's magnitude (a flipped window rounding moves a maximum by
# at most that), the gradient as this script holds fold gradients: all but
# GRAD_FLIP_SHARE of its elements within BWD_BF16_ULPS ulps (a near-tie
# that the flip crowns otherwise routes a pixel's cotangent to another
# part). Batch chunks run the same per-sample work, and are held bit for
# bit; where cuBLAS tiles another batch count otherwise the same
# tolerances apply and the line says so.
CHUNK_BATCH, CHUNK_TRAIN_BATCHES, CHUNK_STEPS = 32, (64, 32), 2
CHUNK_SETTINGS = (
    {"PT_WARP_PLACE_CHUNK_MB": None, "PT_WARP_JOINT_GROUP": None},
    {"PT_WARP_PLACE_CHUNK_MB": "512", "PT_WARP_JOINT_GROUP": None},
    {"PT_WARP_PLACE_CHUNK_MB": None, "PT_WARP_JOINT_GROUP": "3"})
CHUNK_WANT = ([32], [9, 9, 9, 5], [32])
# the training steps' chunks per stage (256², 128², 64²) under the default
# cap of 3072 MiB, by JAX's estimate p·s_y·(w + s_x)·c·2 bytes a sample
# with the 9 active parts: 56.25, 29.25 and 15.75 MiB, so only stage 0 at
# b64 splits (54 + 10). A step launches fold_place twice per chunk (the
# disc phase's forward, the gen phase's with its argmax), fold_place_idx
# and fold_route once
CHUNK_TRAIN_WANT = {64: ((54, 10), (64,), (64,)),
                    32: ((32,), (32,), (32,))}
# phase 18 (data_parallel): fashion-256, bf16, global batch 16, 2 steps,
# dropout on. The nets after each step against the single process's: JAX's
# mesh-test tolerance (tests/test_parallel.py:69-76), rtol 2e-3 and atol
# one Adam update quantum 2·lr (+ 2.5 %) per step. A near-zero gradient
# whose sign differs between the runs moves its parameter in the other
# direction: a rank rounds its half-batch's bf16 weight gradient before
# the all-reduce, one device the whole batch's, so in bf16 such flips are
# common (measured on an H100: 449 461 of 85 M elements beyond one quantum
# after 2 steps). Adam's first step is ±lr·g/(|g| + ε), its second from
# these betas at most 1.054·lr (the largest |m̂2|/√v̂2 over g2/g1): after
# 2 steps the runs may differ by 2·lr·2.054, and the bound after step k
# sums the quanta of steps 1..k. That bound holds whatever the gradients
# are, so the runs are held where they can differ: the gradients each
# phase hands its optimizer (the all-reduced ones against one process's
# on the global batch, dryrun.grad_errors: the 2-norm of the difference
# over the net's, and the worst such ratio of a tensor holding at least
# 1e-3 of the net's norm) and the losses of every step. Measured on an
# H100 for 2 gloo ranks: 4.5e-3-1.87e-2 over the net, 0.011-0.195 for the
# worst tensor (both largest in step 2's gen phase), losses within 1.04e-3;
# one NCCL rank 0. A wrong all-reduce (no sum, no division by the ranks)
# or wrong dropout rows give 0.4-1.0 over the net
DP_BATCH, DP_STEPS = 16, 2
DP_PARAM_RTOL = 2e-3
DP_PARAM_ATOL = (4.1e-4, 4.1e-4 * 2.054)        # after step 1, step 2
DP_GRAD_RTOL, DP_GRAD_RTOL_TENSOR = 1e-1, 5e-1
DP_LOSS_TOL = dict(rtol=2e-3, atol=4e-3)
DP_RANK_TIMEOUT_S = 600


def _chunk_grad_ok(out, grad, ref_out, ref_grad):
    """(bitwise, within tolerance) of a chunked or grouped fold against the
    one-call fold (the tolerances of CHUNK_SETTINGS' note)."""
    bitwise = torch.equal(out, ref_out) and torch.equal(grad, ref_grad)
    d_out = (out.float() - ref_out.float()).abs()
    d_grad = (grad.float() - ref_grad.float()).abs()
    out_ok = bool(_bf16_within(d_out, ref_out.float(), 1).all())
    over = int((~_bf16_within(d_grad, ref_grad.float(), BWD_BF16_ULPS))
               .sum().item())
    within = out_ok and over <= GRAD_FLIP_SHARE * d_grad.numel()
    return bitwise, within, over


def phase_chunked(card: str) -> dict:
    """The fold's memory chunking at full width; returns its launches."""
    dev = torch.device("cuda")
    image = (256, 256)
    feats, warps, masks = bench_fold._fold_inputs(
        CHUNK_BATCH, image, 18, 0, torch.bfloat16, dev)
    _reset_counts()
    lines, results = bench_fold.batchchunk(
        feats, warps, masks, image, list(CHUNK_SETTINGS), BENCH_ITERS,
        BENCH_WARMUP)
    launches = _counts()
    ref_out, ref_grad = results[0]
    grads = [ln for ln in lines if ln["mode"] == "grad"]
    for i, (setting, want) in enumerate(zip(CHUNK_SETTINGS, CHUNK_WANT)):
        pair = [ln for ln in lines if ln["setting"] == setting]
        check(all(ln["chunks"] == want for ln in pair),
              f"{setting}: chunks {pair[0]['chunks']} != {want}")
        for ln in pair:
            grad_mode = ln["mode"] == "grad"
            check(ln["launches"] == {"fold_place": len(want),
                                     "fold_route": len(want) * grad_mode,
                                     "scan_fallback": 0},
                  f"{setting} {ln['mode']}: launches {ln['launches']}")
        bitwise, within, over = _chunk_grad_ok(*results[i], ref_out,
                                               ref_grad)
        grouped = setting["PT_WARP_JOINT_GROUP"] is not None
        emit({**{k: v for k, v in grads[i].items() if k != "setting"},
              "phase": "chunked_fold", "setting": setting, "card": card,
              "fwd_ms": pair[0]["ms"], "fwd_temp_hbm_gb":
              pair[0]["temp_hbm_gb"], "bitwise_equal": bitwise,
              "grad_elements_over_tol": over,
              "within_tolerance": within, "tolerance":
              "bitwise expected" if not grouped else "grouped GEMMs"})
        check(bitwise or within, f"{setting}: chunked fold != one call")
    del results, ref_out, ref_grad, feats

    # the training step at b64 under the default cap, beside b32: every
    # kernel-placed fold instance launches once per chunk
    out = {}
    for batch in CHUNK_TRAIN_BATCHES:
        cfg = dataclasses.replace(_fashion(), batch_size=batch)
        run = _steps(cfg, CHUNK_STEPS, seed=9)
        counts = run["counts"]
        chunks = sum(len(st) for st in CHUNK_TRAIN_WANT[batch])
        want = {"fold_place": 2 * chunks * CHUNK_STEPS,
                "fold_place_idx": chunks * CHUNK_STEPS,
                "fold_route": chunks * CHUNK_STEPS, "scan_fallback": 0}
        got = {k: counts[k] for k in want}
        check(got == want, f"b{batch}: launches {got} != one per chunk "
              f"{want}")
        emit({"phase": "chunked_train", "card": card, "batch": batch,
              "dtype": "bfloat16", "steps": CHUNK_STEPS,
              "chunks_by_stage": CHUNK_TRAIN_WANT[batch],
              "losses": {"gen [total, ll, ad]": run["rows"]["gen"],
                         "disc [total, true, fake]": run["rows"]["disc"]},
              "fold_place_launches": counts["fold_place"],
              "fold_place_idx_launches": counts["fold_place_idx"],
              "fold_route_launches": counts["fold_route"],
              "scan_fallbacks": counts["scan_fallback"],
              "step_ms": run["step_ms"],
              "peak_mem_gb": run["peak_mem_gb"]})
        out[batch] = counts
        del run
        torch.cuda.empty_cache()
    return {k: launches[k] + sum(c[k] for c in out.values())
            for k in launches}


def _dp_batches(cfg: GANConfig, seed: int) -> list:
    rng = np.random.default_rng(seed)

    def draw():
        return synthetic_compact_batch(rng, cfg.batch_size, cfg.image_size,
                                       cfg.pose_dim)
    return [(_stacked(draw()), _stacked(draw()), draw())
            for _ in range(DP_STEPS)]


def _dp_compare(got: list, want: list) -> list:
    """Per step: max |diff|, elements beyond the step's DP tolerance and
    bitwise equality of two runs' nets (host snapshots {'gen': sd, 'disc':
    sd} after each step)."""
    rows = []
    for atol, a, b in zip(DP_PARAM_ATOL, got, want):
        worst, over, same = 0.0, 0, True
        for net in ("gen", "disc"):
            for k, w in b[net].items():
                g = a[net][k]
                d = (g.double() - w.double()).abs()
                worst = max(worst, d.max().item())
                over += int((d > atol + DP_PARAM_RTOL * w.double().abs())
                            .sum().item())
                same = same and torch.equal(g, w)
        rows.append({"atol": atol, "max_abs_diff": worst,
                     "elements_over_tol": over, "bitwise_equal": same})
    return rows


def _dp_hold(part: str, got: dict, grads_a: list, rows_a: list) -> dict:
    """A data-parallel run's gradients (per phase) and losses (per step)
    against the single process's; checks both, returns the readings."""
    errs = dryrun.grad_errors(got["grads"], grads_a)
    check(len(errs) == 2 * DP_STEPS, f"{part}: {len(errs)} phases logged")
    check(all(e["rel"] <= DP_GRAD_RTOL and e["worst"] <= DP_GRAD_RTOL_TENSOR
              for e in errs), f"{part}: gradients vs one process {errs}")
    loss_ok = all(np.allclose(g[k], w[k], **DP_LOSS_TOL)
                  for g, w in zip(got["metrics"], rows_a, strict=True)
                  for k in w)
    check(loss_ok, f"{part}: losses {got['metrics']} vs {rows_a}")
    return {"grads_vs_single_process_by_phase": errs,
            "grad_rtol": [DP_GRAD_RTOL, DP_GRAD_RTOL_TENSOR],
            "losses_within": DP_LOSS_TOL}


def _sum_launches(*counts) -> dict:
    return {k: sum(c.get(k, 0) for c in counts) for k in KERNELS}


def phase_data_parallel(card: str) -> dict:
    """Data-parallel training and serving on the one card; returns the
    launches of every part that ran in this process or in its ranks."""
    note = ("one card: the ranks and replicas share it; no time here is "
            "a scaling result")
    cfg = dataclasses.replace(_fashion(), batch_size=DP_BATCH)
    batches = _dp_batches(cfg, seed=11)
    job = {"config": cfg, "batches": batches, "seed": 0, "snapshots": True,
           "grads": True}

    # (a) the reference: one process, b16
    state = create_state(cfg, seed=0, device="cuda")
    step = make_train_step(cfg, state)
    grads_a = dryrun.record_grads(step)
    _reset_counts()
    t0 = time.perf_counter()
    rows, single = [], []
    for b in batches:
        m, _ = step(*b)
        rows.append({k: v.tolist() for k, v in m.items()})
        single.append(pmesh.unreplicate_state(state))
    torch.cuda.synchronize()
    ms_a = (time.perf_counter() - t0) / DP_STEPS * 1e3
    launch_a = _counts()
    check(all(np.isfinite(r[k]).all() for r in rows for k in r),
          f"single-process losses {rows}")
    emit({"phase": "data_parallel", "part": "a_single_process",
          "card": card, "batch": DP_BATCH, "dtype": "bfloat16",
          "steps": DP_STEPS, "losses": rows, "step_ms": ms_a,
          "step_ms_includes": "the gradients' copies to the host",
          "launches": {k: launch_a[k] for k in KERNELS}, "note": note})
    del state, step
    torch.cuda.empty_cache()

    # (b) two ranks on the one card over gloo, CUDA tensors
    t0 = time.perf_counter()
    ranks = dryrun.train_ranks([job], ["cuda:0", "cuda:0"], backend="gloo",
                               timeout=DP_RANK_TIMEOUT_S)
    secs_b = time.perf_counter() - t0
    r0, r1 = ranks[0][0], ranks[1][0]
    between = _dp_compare(r1["snapshots"], r0["snapshots"])
    vs_single = _dp_compare(r0["snapshots"], single)
    held_b = _dp_hold("two ranks", r0, grads_a, rows)
    emit({"phase": "data_parallel", "part": "b_two_ranks_gloo",
          "card": card, "backend": r0["backend"], "world": r0["world"],
          "losses": r0["metrics"], **held_b, "ranks_bitwise_equal":
          all(r["bitwise_equal"] for r in between),
          "vs_single_process_by_step": vs_single, "rtol": DP_PARAM_RTOL,
          "step_ms": [r["step_ms"] for r in (r0, r1)],
          "allreduce_ms_per_step": [r["comm_ms"] / DP_STEPS
                                    for r in (r0, r1)],
          "peak_mem_gb": [r["peak_mem_gb"] for r in (r0, r1)],
          "launches": [{k: r["launches"][k] for k in KERNELS}
                       for r in (r0, r1)],
          "seconds_with_spawn": secs_b, "note": note})
    check(all(r["bitwise_equal"] for r in between),
          "the two ranks' nets differ")
    check(r0["metrics"] == r1["metrics"], "the ranks' metrics differ")
    check(all(r["elements_over_tol"] == 0 for r in vs_single),
          f"two ranks vs one process: {vs_single}")
    check(all(r["launches"]["fold_place"] > 0
              and r["launches"]["fold_route"] > 0 for r in (r0, r1)),
          "a rank launched no fold kernel")

    # (c) one rank over NCCL, in this process
    tmp = tempfile.mkdtemp(prefix="dp_nccl_")
    group = pmesh.init_group(0, 1, "cuda:0", os.path.join(tmp, "store"),
                             "nccl")
    try:
        rc = dryrun.run_job(group, job)
    finally:
        pmesh.close_group()
        shutil.rmtree(tmp, ignore_errors=True)
    vs_a = _dp_compare(rc["snapshots"], single)
    held_c = _dp_hold("one NCCL rank", rc, grads_a, rows)
    emit({"phase": "data_parallel", "part": "c_one_rank_nccl",
          "card": card, "backend": rc["backend"], "losses": rc["metrics"],
          **held_c,
          "vs_single_process_by_step": vs_a, "rtol": DP_PARAM_RTOL,
          "deterministic_algorithms": False,
          "step_ms": rc["step_ms"],
          "allreduce_ms_per_step": rc["comm_ms"] / DP_STEPS,
          "peak_mem_gb": rc["peak_mem_gb"],
          "launches": {k: rc["launches"][k] for k in KERNELS},
          "note": note})
    check(rc["backend"] == "nccl", "the rank did not run on NCCL")
    check(all(r["elements_over_tol"] == 0 for r in vs_a),
          f"one NCCL rank vs one process: {vs_a}")
    del single, grads_a, r0["grads"], rc["grads"]

    # (d) cli.main over two ranks on the card, its files resumed on one
    launch_d = _dp_cli(card, note)

    # (e) the server with two replicas on the card against one
    cfg8 = _fashion()
    gen = build_models(cfg8, seed=0, device="cuda")
    reqs = make_requests(np.random.default_rng(12), BATCH, (256, 256))
    with PoseTransferServer(cfg8, gen, max_wait_ms=200.0) as srv:
        srv.generate(reqs)                              # warm-up
        want = srv.generate(reqs)
    with PoseTransferServer(pmesh.config_for_mesh(cfg8, 2), gen,
                            devices=["cuda:0", "cuda:0"],
                            max_wait_ms=200.0) as srv:
        srv.generate(reqs)                              # warm-up
        srv.reset_stats()
        _reset_counts()
        got = srv.generate(reqs)
        stats = srv.stats()
        launch_e = _counts()
    check_images(got, BATCH, "two-replica server")
    diff = np.abs(got - want)
    forwards = 2 * stats["batches"]
    emit({"phase": "data_parallel", "part": "e_server_two_replicas",
          "card": card, "batch": BATCH, "replicas": 2,
          "max_abs_diff": float(diff.max()),
          "mean_abs_diff": float(diff.mean()),
          "replica_forwards": forwards,
          "launches": {k: launch_e[k] for k in KERNELS},
          "scan_fallbacks": launch_e["scan_fallback"], "note": note})
    check(diff.max() <= BF16_MAX_ABS and diff.mean() <= BF16_MEAN_ABS,
          "two replicas vs one server")
    check(launch_e["fold_place"] + launch_e["scan_fallback"]
          == 3 * forwards and launch_e["fold_place"] > 0,
          f"two-replica launches {launch_e}")
    return _sum_launches(launch_a, r0["launches"], r1["launches"],
                         rc["launches"], launch_d, launch_e)


def _dp_cli(card: str, note: str) -> dict:
    """cli.main --num_devices 2 on the one card (gloo ranks), one epoch of
    2 iterations with a display and a checkpoint; then a single-device
    --resume 1 on its files. Returns the launches of the resumed run (the
    ranks' are counted in their processes)."""
    tmp = tempfile.TemporaryDirectory(prefix="dp_cli_")
    root = Path(tmp.name)
    data = str(root / "data") + "/"
    _cli(cli_data.main, ["--out", data, "--dataset", "fasion",
                         "--pose_dim", "18"])
    flags = ["--expID", "dp", "--data_Dir", data, "--dataset", "fasion",
             "--pose_dim", "18", "--compute_dtype", "bfloat16",
             "--batch_size", str(BATCH), "--iters_per_epoch", "2",
             "--checkpoint_ratio", "1", "--display_ratio", "2",
             "--checkMode", "0", "--exp_root", str(root / "exp")]
    exp = root / "exp" / "dp"
    out, secs = _cli(functools.partial(cli_main.main,
                                       rank_timeout=DP_RANK_TIMEOUT_S),
                     flags + ["--number_of_epochs", "1", "--device",
                              "cuda:0", "--num_devices", "2"])
    rows = [json.loads(ln) for ln in
            (exp / "metrics.jsonl").read_text().splitlines()]
    saved = sorted(p.name for p in (exp / "models").iterdir())
    grids = {d: len(list((exp / "results" / d).iterdir()))
             for d in ("train", "test")}
    check("Data-parallel over 2 ranks: ['cuda:0', 'cuda:0']" in out,
          "cli.main did not start 2 ranks")
    check(len(rows) == 1 and all(math.isfinite(v) for k, v in
                                 rows[0].items() if k not in ("epoch",
                                                              "it")),
          f"data-parallel metrics.jsonl {rows}")
    check(saved == ["disc_001.pt", "gen_001.pt"], f"checkpoints {saved}")
    check(grids == {"train": 1, "test": 1}, f"grids {grids}")
    emit({"phase": "data_parallel", "part": "d_cli_two_ranks",
          "card": card, "seconds": secs, "batch": BATCH,
          "losses": rows, "checkpoints": saved, "grids": grids,
          "launches": "counted in the ranks' processes, not here",
          "note": note})
    _reset_counts()
    out, secs = _cli(cli_main.main, flags + [
        "--number_of_epochs", "2", "--device", "cuda", "--num_devices", "1",
        "--resume", "1"])
    counts = _counts()
    saved = sorted(p.name for p in (exp / "models").iterdir())
    check("Resume gen from epoch 1" in out and "Epoch : 2" in out
          and "gen_002.pt" in saved, "single-device resume of the files")
    emit({"phase": "data_parallel", "part": "d_cli_resume_one_device",
          "card": card, "seconds": secs, "checkpoints": saved,
          "launches": {k: counts[k] for k in KERNELS}})
    tmp.cleanup()
    return counts


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
    # this slice's paths; each sums its own launches
    recipe_launches, nn_k = phase_recipe(smi, flush)
    main_k.update(nn_k)
    del flush
    new_paths = [recipe_launches, phase_stacked(smi)]
    phase_unet(smi)
    new_paths.append(phase_cli_recipe(smi))
    # the HTTP front and the msgpack resume on JAX-layout files,
    # 'exact', the Keras importer
    tmp = tempfile.TemporaryDirectory(prefix="jax_layout_")
    root = Path(tmp.name)
    written, _ = _jax_layout_run(root)
    new_paths.append(phase_http_serve(smi, root, written))
    new_paths.append(phase_resume_msgpack(smi, root, written))
    del written
    tmp.cleanup()
    phase_exact(smi)
    phase_keras(smi)
    # the fold's memory chunking; data-parallel training and serving
    new_paths.append(phase_chunked(smi))
    new_paths.append(phase_data_parallel(smi))

    def new(name):
        return sum(p.get(name, 0) for p in new_paths)

    def main_paths(name):
        # every main path of the fashion and h36m phases, both backends
        return serve_launches[name] + train_launches[name] \
            + pallas_serve[name] + pallas_train[name] + cli_launches[name] \
            + new(name)

    tpu = "pose_transfer_tpu/ops/"
    rows = (
        ("fold_place",
         serve_launches["fold_place"] + train_launches["fold_place"]
         + cli_launches["fold_place"] + new("fold_place"),
         tpu + "warp_fused.py:189", []),
        ("fold_route", train_launches["fold_route"]
         + cli_launches["fold_route"] + new("fold_route"),
         tpu + "warp_fused.py:380", []),
        # the forward's two passes (pass 1 :223, pass 2 :243), fused
        ("warp_fold", pallas_serve["warp_fold"] + pallas_train["warp_fold"]
         + new("warp_fold"),
         tpu + "warp_pallas.py:223", [tpu + "warp_pallas.py:243"]),
        # the backward's two transposed passes (:288, :307), fused
        ("warp_fold_bwd", pallas_train["warp_fold_bwd"]
         + new("warp_fold_bwd"),
         tpu + "warp_pallas.py:288", [tpu + "warp_pallas.py:307"]),
        ("fold_place_stream", stream_launches,
         tpu + "warp_fused.py:300", []),
        # no TPU kernel: the banded dots of the windowed warp (:416) and of
        # its transpose (:512), and the full map's (:332)
        ("warp_taps", main_paths("warp_taps"), tpu + "warp.py:416", []),
        ("warp_taps_t", main_paths("warp_taps_t"), tpu + "warp.py:512",
         [tpu + "warp.py:332"]),
        # no TPU kernel: the chain of shifts that XLA fuses under jit
        # (nn_loss.py:96, its custom VJP's forward; :114, its backward)
        ("nn_loss_fwd", new("nn_loss_fwd"), tpu + "nn_loss.py:96", []),
        ("nn_loss_bwd", new("nn_loss_bwd"), tpu + "nn_loss.py:114", []),
        # no TPU kernel: the plain jnp norm that XLA fuses under jit
        # (norm.py:17), forward and its autodiff
        ("volume_norm_fwd", main_paths("volume_norm_fwd"),
         tpu + "norm.py:17", []),
        ("volume_norm_bwd", main_paths("volume_norm_bwd"),
         tpu + "norm.py:17", []),
    )
    kernels = []
    for name, launches, replaces, also in rows:
        m = main_k[name]
        # warp_taps.cu holds both tap kernels, nn_loss.cu both nn_loss
        # ones, volume_norm.cu both norm ones
        source = {"warp_taps_t": "warp_taps", "nn_loss_fwd": "nn_loss",
                  "nn_loss_bwd": "nn_loss", "volume_norm_fwd": "volume_norm",
                  "volume_norm_bwd": "volume_norm"}.get(name, name)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pose_transfer_torch/csrc/{source}.cu",
            "replaces": replaces, "also_replaces": also,
            "launches": launches, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": "bytes" if m["bytes_ms"] >= m["ops_ms"]
            else "operations",
            "library_ms": m.get("library_ms"), "checked_vs_plain": True,
            **{k: v for k, v in m.items() if k.endswith("_main")}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
