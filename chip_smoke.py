#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):
  1. device   card name, and name + power limit as nvidia-smi reports them
  2. build    compile every kernel of pose_transfer_torch/csrc with nvcc
  3. kernels  each kernel against its plain PyTorch version at the shapes
              the serving and training paths give it (bitwise), with its
              time, the plain version's time and the least time for its
              bytes and operations
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
  6. the kernels line, then the last line {"ok": true, "device": {...}}

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
from pose_transfer_torch.data.device import make_batch_preparer
from pose_transfer_torch.data.synthetic import random_image, random_skeleton
from pose_transfer_torch.ops import warp as warp_mod
from pose_transfer_torch.ops import warp_fused
from pose_transfer_torch.serve import PoseTransferServer
from pose_transfer_torch.data.synthetic import synthetic_compact_batch
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
# bf16 serving: the kernel-placed and the full-scan fold compute the same
# taps and the same roundings, so the outputs agree unless cuBLAS sums an
# einsum in another order and flips a bf16 rounding in a skip (≤ 2^-8
# relative), which the decoder then carries: max 0.05, mean 1e-3 on the
# tanh output. In f32 (TF32 off) the same comparison holds max 1e-4.
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
    bf16)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    main = {"fold_place": _summary(), "fold_route": _summary()}
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


def _reset_counts() -> None:
    for k in warp_fused.LAUNCHES:
        warp_fused.LAUNCHES[k] = 0
    warp_mod.COUNTS["scan_fallback"] = 0


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
        _reset_counts()
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
        _reset_counts()
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


def _stacked(batch: dict) -> dict:
    """One compact batch as the training_ratio=1 stack of draws."""
    return {k: v[None] for k, v in batch.items()}


def phase_train(card: str) -> dict:
    """Full-width bf16 training steps through the entry points a trainer
    calls: ``create_state`` then ``make_train_step``."""
    cfg = GANConfig(image_size=(256, 256), pose_dim=18, batch_size=BATCH,
                    compute_dtype=torch.bfloat16)
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
    launches = dict(warp_fused.LAUNCHES)
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
    check(place + fallbacks == 6 * TRAIN_STEPS,
          f"{place} fold_place launches + {fallbacks} fallbacks != 6 per "
          "step (two forwards x three windowed stages)")
    check(route == launches["fold_place_idx"],
          f"{route} fold_route launches != {launches['fold_place_idx']} "
          "generator-phase fold_place launches with the argmax")
    check(route > 0 and place > 0, "training launched no fold kernel")
    images = BATCH * (2 * cfg.training_ratio + 1)
    emit({"phase": "train", "card": card, "batch": BATCH, "dtype": "bfloat16",
          "steps": TRAIN_STEPS, "gen_params": n_gen, "disc_params": n_disc,
          "losses": {"gen [total, ll, ad]": rows["gen"],
                     "disc [total, true, fake]": rows["disc"]},
          "fold_place_launches": place,
          "fold_place_idx_launches": launches["fold_place_idx"],
          "fold_route_launches": route, "scan_fallbacks": fallbacks,
          "step_ms": wall_s / TRAIN_STEPS * 1e3,
          # 3 steps after one warm-up: a smoke reading, not a benchmark
          # (tools/profile_train.py measures); images per step counted as
          # N·(2·training_ratio + 1), the generator forwards' inputs
          "smoke_train_img_per_s": images * TRAIN_STEPS / wall_s,
          "peak_mem_gb": peak_gb})
    del state, step, before, after
    return launches


def phase_fold_grad() -> dict:
    """The fold's f32 gradient through the kernels against autograd
    through the plain full-scan fold, at one real batch's warps and masks,
    for the three windowed stages (seeded features and cotangent)."""
    prep = make_batch_preparer(image_size=(256, 256), pose_dim=18,
                               device="cuda")(synthetic_compact_batch(
                                   np.random.default_rng(3), BATCH,
                                   (256, 256), 18))
    warps, masks = prep["warps"], prep["masks"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    res = []
    for h, c, _, _ in STAGES:
        f = torch.randn((BATCH, h, h, c), generator=gen, device="cuda")
        g = torch.randn((BATCH, h, h, c), generator=gen, device="cuda")
        plan = warp_mod.plan_folds([tuple(f.shape)], warps, masks,
                                   torch.float32, windowed=True)[0]
        check(plan.windows is not None and plan.fits,
              f"stage {h}: the real batch does not take the windowed fold")
        _reset_counts()
        fk = f.clone().requires_grad_(True)
        warp_mod.affine_transform_layer(fk, warps, masks, (256, 256),
                                        windowed=True, plan=plan).backward(g)
        torch.cuda.synchronize()
        check(warp_fused.LAUNCHES["fold_route"] == 1
              and warp_fused.LAUNCHES["fold_place_idx"] == 1,
              f"stage {h}: the kernel path did not run")
        fp = f.clone().requires_grad_(True)
        out, _ = warp_mod._fold_scan(fp, warps, plan.masks_r, (256, 256),
                                     "max", emit_idx=False)
        out.backward(g)
        diff = (fk.grad - fp.grad).abs()
        scale = fp.grad.abs().max().item()
        over = (diff > GRAD_REL_TOL * scale).sum().item()
        r = {"phase": "fold_grad_kernel_vs_plain", "dtype": "float32",
             "shape": [BATCH, h, h, c], "max_abs_ref": scale,
             "max_abs_diff": diff.max().item(),
             "mean_abs_diff": diff.mean().item(),
             "elements_over_tol": over, "elements": diff.numel()}
        emit(r)
        check(over <= GRAD_FLIP_SHARE * diff.numel(),
              f"stage {h}: {over} gradient elements differ by more than "
              f"{GRAD_REL_TOL} of the largest")
        res.append(r)
        del fk, fp, out, diff
    return res


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
    main_k = phase_kernels(flush)
    del flush
    serve_launches = phase_serve(smi)
    train_launches = phase_train(smi)
    phase_fold_grad()

    kernels = []
    for name, launches in (
            ("fold_place", serve_launches + train_launches["fold_place"]),
            ("fold_route", train_launches["fold_route"])):
        m = main_k[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pose_transfer_torch/csrc/{name}.cu",
            "replaces": "pose_transfer_tpu/ops/warp_fused.py:"
            + ("189" if name == "fold_place" else "380"),
            "launches": launches, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": "bytes" if m["bytes_ms"] >= m["ops_ms"]
            else "operations",
            "library_ms": None, "checked_vs_plain": True})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
