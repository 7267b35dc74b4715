"""Isolated warp-fold microbenchmark.

    python3 -m pose_transfer_torch.tools.bench_fold [--batch 32] [--stage 0]
        [--mode {fwd,grad}] [--variant full,xla,kernel] [--dtype bfloat16]
        [--iters 20] [--warmup 5] [--device {cuda,cpu}]
        [--experiment {ramp,joint,joint_bwd,partstream,batchchunk}]
        [--groups 3] [--stream_idx] [--caps unset,1024,512,256]

Counterpart of the JAX package's ``tools/bench_fold.py``, with its options
and JSON keys, so that the two outputs can be read side by side. Times
``ops.warp.affine_transform_layer`` at one generator skip stage of
fashion-256 (or ``--image_size``), outside the train step, on the fold
inputs a train step sees (synthetic skeletons' transforms and masks, seeded
features). Variants: the full scan ('full'), the windowed fold with the
XLA-style placement ('xla') or the placement kernel ('kernel'); ``--mode
fwd`` is the no-grad forward, ``grad`` the forward and the feature
gradient. Experiments instead of variants:
- ``partstream``: the part groups of the windowed fold streamed through
  ``fold_place_stream`` (the ``--groups`` groups' windowed warps one after
  the other, each placed into a state initialised from the masked body, the
  zero pass at the end) against the monolithic ``fold_place`` on the whole
  wins stack: ms per call, the peak device memory of each leg, and whether
  the two outputs are equal. Both legs run without the argmax, as in the
  JAX tool; ``--stream_idx`` runs both with it and compares the argmax too.
- ``batchchunk``: the kernel-placed fold, forward (no grad, as
  ``partstream`` runs it) and forward with the feature gradient, under
  ``PT_WARP_PLACE_CHUNK_MB`` caps (``--caps``; ``unset`` is the default
  3072): the chunks, ms per call, peak device memory of each, the
  ``fold_place`` / ``fold_route`` launches of one call, and whether output
  and gradient equal the first cap's.
- ``ramp``: the windowed warps of the parts on the dense banded weights
  (built in the call, as the CPU path does), the weights' build alone and
  the two products on prebuilt weights; then the ``taps`` leg, the card's
  path: ``warp_taps`` and ``warp_taps_t`` on the same windows and on the
  full map, with their byte bounds.
- ``joint`` and ``joint_bwd``: the layout in which the windowed warp's
  (transposed) two passes hand over their intermediate.

One JSON line per measurement. Times are CUDA-event ms per call after
``--warmup`` calls; ``--device cpu`` runs the same code on the CPU for
checks (its times are the CPU's, not the card's). ``--device cuda`` (the
default) needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from ..core.transforms_host import static_empty_parts
from ..data.device import masks_from_polys
from ..data.synthetic import synthetic_compact_batch
from ..models.networks import encoder_filters_for
from ..ops import warp as W
from ..ops import warp_fused as WF

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the ramp experiment's prebuilt weights are probed at the largest batch
# whose weights stay under this many GiB (ms per sample scales linearly)
RAMP_PROBE_GB = 16.0


def _stage_shape(image_size, stage):
    enc = encoder_filters_for(image_size)
    return image_size[0] >> stage, image_size[1] >> stage, enc[stage]


def _fold_inputs(batch, image_size, pose_dim, stage, dtype, device, seed=0):
    """Fold inputs: warps and masks from the synthetic skeleton sampler
    (the geometry a train step sees), features drawn after them from the
    same numpy generator, at the stage's shape; the JAX tool's inputs for
    the same seed."""
    rng = np.random.default_rng(seed)
    raw = synthetic_compact_batch(rng, batch, image_size, pose_dim,
                                  warp_skip="mask")
    h, w, c = _stage_shape(image_size, stage)
    feats = torch.tensor(rng.standard_normal((batch, h, w, c)),
                         dtype=torch.float32).to(dtype).to(device)
    warps = torch.tensor(raw["warps"], device=device)
    masks = masks_from_polys(torch.tensor(raw["mask_polys"], device=device),
                             torch.tensor(raw["mask_kinds"], device=device),
                             image_size)
    return feats, warps, masks.to(dtype)


def time_call(fn, iters: int, warmup: int, device) -> float:
    """Mean ms per call: CUDA events around the calls after ``warmup``
    calls, then a synchronize (the host clock on the CPU)."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _windows(feats, warps, masks, static_empty=()):
    """The windows of the non-body parts not in ``static_empty``: the
    placement kernel's where the shape has them, else the (h/2, w/2) ones
    of the XLA-style placement: (masks_r, sel, y0, x0, s_y, s_x) with y0,
    x0 (N, T)."""
    h, w = feats.shape[1:3]
    sizes = W._kernel_window_sizes(h, w)
    s_y, s_x = sizes or (h // 2, w // 2)
    masks_r = W.resize_bilinear(masks.to(feats.dtype), (h, w))
    y0, x0, _, _ = W._support_windows(masks_r, s_y, s_x,
                                      WF.X_ALIGN if sizes else 1)
    sel = list(W._place_actives(warps.shape[1], static_empty))
    return masks_r, sel, y0, x0, s_y, s_x


def _peak_gb(fn, device):
    """(result, GiB of device memory the call held above what was allocated
    before it); None on the CPU."""
    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def partstream(feats, warps, masks, image_size, groups: int,
               stream_idx: bool, iters: int, warmup: int) -> list[dict]:
    """The partstream experiment's JSON lines: one per leg, then the
    comparison of the two legs' outputs."""
    device = feats.device
    n, h, w, c = feats.shape
    masks_r, sel, y0, x0, s_y, s_x = _windows(feats, warps, masks)
    p = len(sel)
    if p % groups:
        raise ValueError(f"groups {groups} must divide parts {p}")
    pg = p // groups
    mwins = W._slice_win(masks_r[:, sel], y0[:, sel], x0[:, sel], s_y,
                         s_x).contiguous()
    offs = W._place_offs(y0, x0, sel)
    zero_nb = (masks_r[:, 1:] == 0).any(dim=1)
    grp = [slice(k * pg, (k + 1) * pg) for k in range(groups)]
    # each group's slices of the (small) mask windows and offsets, as the
    # JAX tool's scan hands them over
    mw_g = [mwins[:, s].contiguous() for s in grp]
    offs_g = [offs[:, s].contiguous() for s in grp]

    def body():
        return (W._warp_full(feats, warps[:, 0], image_size)
                * masks_r[:, 0][..., None]).contiguous()

    def prod():
        wins = W._warp_win(feats, warps[:, sel], y0[:, sel], x0[:, sel], s_y,
                           s_x, image_size).contiguous()
        return WF.fold_place(body(), wins, mwins, zero_nb, offs, stream_idx)

    def stream():
        acc = body()
        idx = torch.zeros(acc.shape, dtype=torch.int8, device=device) \
            if stream_idx else None
        for s, mw, off in zip(grp, mw_g, offs_g):
            part = sel[s]
            wins = W._warp_win(feats, warps[:, part], y0[:, part],
                               x0[:, part], s_y, s_x, image_size).contiguous()
            WF.fold_place_stream(acc, idx, wins, mw, off)
        # the zero pass the monolithic kernel fuses
        take0 = zero_nb[..., None] & (acc < 0)
        acc.masked_fill_(take0, 0)
        if idx is not None:
            idx.masked_fill_(take0, -1)
        return acc, idx

    lines, outs = [], {}
    with torch.no_grad():
        for name, fn in (("prod_monolithic", prod),
                         (f"partstream_g{groups}", stream)):
            outs[name], temp_gb = _peak_gb(fn, device)
            ms = time_call(fn, iters, warmup, device)
            lines.append({
                "experiment": "partstream", "leg": name, "batch": n,
                "shape": [h, w, c], "groups": groups if "stream" in name
                else 1, "stream_idx": stream_idx, "ms": ms,
                "temp_hbm_gb": temp_gb, "backend": device.type})
    (a, ai), (b, bi) = outs.values()
    res = {"experiment": "partstream", "groups": groups,
           "bitexact": bool(torch.equal(a, b)),
           "max_abs_diff": (a.float() - b.float()).abs().max().item()}
    if stream_idx:
        res["idx_equal"] = bool(torch.equal(ai, bi))
    lines.append(res)
    return lines


@contextlib.contextmanager
def fold_env(setting: dict):
    """The fold's environment variables set to ``setting`` (a value of
    None unsets one) inside the block, restored after it."""
    saved = {k: os.environ.get(k) for k in setting}
    try:
        for k, v in setting.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fold_chunks(feats, warps) -> list[int]:
    """Samples per call of the kernel-placed fold under the current
    ``PT_WARP_PLACE_CHUNK_MB`` (every part active)."""
    n, h, w, c = feats.shape
    p = len(W._place_actives(warps.shape[1], ()))
    k = W._place_batch_chunk(n, h, w, c, p, feats.element_size())
    return [sl.stop - sl.start for sl in W._batch_chunks(n, k)]


def batchchunk(feats, warps, masks, image_size, settings: list[dict],
               iters: int, warmup: int, pose_dim: int = 18):
    """The batchchunk experiment: for each fold environment of
    ``settings`` (``fold_env``) the kernel-placed fold's forward ('fwd', no
    grad) and forward with the gradient of ``<out, g>`` by the features
    ('grad', g seeded): one JSON line each, with the chunks, ms per call,
    the peak memory above the inputs, one call's launches (and scan
    fallbacks) and the comparison with the first setting's output and
    gradient. Returns (lines, [(out, grad)] per setting)."""
    device = feats.device
    rng = np.random.default_rng(2)
    g = torch.tensor(rng.standard_normal(tuple(feats.shape)),
                     dtype=torch.float32).to(feats.dtype).to(device)
    fwd = variant_fold("kernel", "fwd", feats, warps, masks, image_size,
                       pose_dim)
    static_empty = static_empty_parts(pose_dim)

    def grad():
        f = feats.detach().requires_grad_(True)
        out = W.affine_transform_layer(
            f, warps, masks, image_size, "mask", "max", windowed=True,
            static_empty=static_empty, place_impl="kernel")
        return out.detach(), torch.autograd.grad(out, f, g)[0]

    lines, results = [], []
    for setting in settings:
        with fold_env(setting):
            chunks = fold_chunks(feats, warps)
            for mode, fn in (("fwd", fwd), ("grad", grad)):
                before = {**WF.LAUNCHES, **W.COUNTS}
                res, temp_gb = _peak_gb(fn, device)
                after = {**WF.LAUNCHES, **W.COUNTS}
                launches = {k: after[k] - before[k] for k in
                            ("fold_place", "fold_route", "scan_fallback")}
                ms = time_call(fn, iters, warmup, device)
                line = {"experiment": "batchchunk", "mode": mode,
                        "setting": setting, "chunks": chunks,
                        "batch": feats.shape[0],
                        "shape": list(feats.shape[1:]), "ms": ms,
                        "temp_hbm_gb": temp_gb, "launches": launches,
                        "backend": device.type}
                if mode == "grad":
                    results.append(res)
                    ref = results[0]
                    line.update(
                        out_equal=bool(torch.equal(res[0], ref[0])),
                        grad_equal=bool(torch.equal(res[1], ref[1])),
                        max_abs_diff_out=(res[0].float() - ref[0].float())
                        .abs().max().item(),
                        max_abs_diff_grad=(res[1].float() - ref[1].float())
                        .abs().max().item())
                lines.append(line)
    return lines, results


def variant_fold(variant: str, mode: str, feats, warps, masks, image_size,
                 pose_dim: int):
    """A call of the fold ``variant`` in ``mode``: the forward's output
    ('fwd', no grad) or the gradient of its sum by the features
    ('grad')."""
    windowed = variant != "full"
    place = {"full": "auto", "xla": "xla", "kernel": "kernel"}[variant]
    static_empty = static_empty_parts(pose_dim)

    def fold(f):
        return W.affine_transform_layer(
            f, warps, masks, image_size, "mask", "max", windowed=windowed,
            static_empty=static_empty, place_impl=place)

    if mode == "fwd":
        def call():
            with torch.no_grad():
                return fold(feats)
        return call

    def call():
        f = feats.detach().requires_grad_(True)
        return torch.autograd.grad(fold(f).sum(), f)[0]
    return call


def taps_bytes(n, h, w, c, p, s_y, s_x, itemsize, out_itemsize) -> int:
    """Least bytes of one ``warp_taps`` or ``warp_taps_t`` launch: each
    input read once, each output written once; the feature map's elements
    take ``out_itemsize`` bytes (f32 for ``warp_taps_t`` with ``joint``)."""
    wins = n * p * s_y * s_x * c * itemsize
    return wins + n * h * w * c * out_itemsize + 32 * n * p


def ramp(feats, warps, masks, image_size, iters, warmup,
         static_empty=()) -> list[dict]:
    """The windowed warps of the parts on the banded products with their
    weights built in the call (``ms_fused``), the weights' build alone and
    the products on prebuilt weights (the last two at a probe batch whose
    weights fit ``RAMP_PROBE_GB``); then the ``taps`` leg:
    ``warp_taps`` and ``warp_taps_t`` on the same call's windows and on the
    full map (the body's and the scan's call), with their byte bounds. The parts in ``static_empty`` are left out, as the fold leaves
    them out."""
    device = feats.device
    n, h, w, c = feats.shape
    _, sel, y0, x0, s_y, s_x = _windows(feats, warps, masks, static_empty)
    wp, yy, xx = warps[:, sel], y0[:, sel], x0[:, sel]
    with torch.no_grad():
        ms_fused = time_call(lambda: W._warp_win_banded(
            feats, wp, yy, xx, s_y, s_x, image_size), iters, warmup, device)
        lines = [{"experiment": "ramp", "leg": "fused", "batch": n,
                  "ms_fused": ms_fused}]
        per_sample_gb = len(sel) * (w * s_y * h + s_y * s_x * w) \
            * feats.element_size() / 2**30
        nb = n
        while nb > 1 and nb * per_sample_gb > RAMP_PROBE_GB:
            nb //= 2
        fp, wpp, yyp, xxp = feats[:nb], wp[:nb], yy[:nb], xx[:nb]

        def build():
            return W._two_pass_weights(wpp, h, w, image_size, feats.dtype,
                                       yyp, xxp, s_y, s_x)
        wy, wx = build()
        ms_weights = time_call(build, iters, warmup, device)
        p = len(sel)

        def dots():
            tmp = torch.matmul(wy.reshape(nb, w, p * s_y, h),
                               fp.permute(0, 2, 1, 3))
            tmp = tmp.reshape(nb, w, p, s_y, c).permute(0, 2, 3, 1, 4)
            return torch.matmul(wx, tmp)
        ms_dots = time_call(dots, iters, warmup, device)
        weights_gb = (wy.numel() + wx.numel()) * wy.element_size() / 2**30
        del wy, wx
    lines.append({
        "experiment": "ramp", "batch": n, "probe_batch": nb,
        "shape": [h, w, c], "window": [s_y, s_x], "ms_fused": ms_fused,
        "ms_dots_precomputed_weights": ms_dots,
        "ms_weight_build": ms_weights,
        "ms_fused_per_sample": ms_fused / n,
        "ms_dots_per_sample": ms_dots / nb,
        "ms_weight_build_per_sample": ms_weights / nb,
        "weights_gb": weights_gb, "backend": device.type})
    return lines + taps(feats, warps, masks, image_size, iters, warmup,
                        static_empty)


def taps(feats, warps, masks, image_size, iters, warmup,
         static_empty=()) -> list[dict]:
    """The ``taps`` leg of the ramp experiment: ms per launch of
    ``warp_taps`` and ``warp_taps_t`` on the windowed call (all the
    non-body parts' windows, ``_windows``, where the stage is windowable;
    the transpose joint, f32 out) and on the full map (one part, as the
    body and the scan call them; the transpose rounded to the dtype), the
    byte bound of each at 3.35 TB/s, the plain versions' ms (one call each)
    and the largest difference from the banded products. The launches run
    back to back, so their inputs are warm in L2 where they fit
    (``chip_smoke.py`` phase 3 times them cold). The kernels take CUDA
    tensors only: on the CPU the leg times the plain versions."""
    device = feats.device
    run, run_t = (WF.warp_taps, WF.warp_taps_t) if device.type == "cuda" \
        else (WF.warp_taps_reference, WF.warp_taps_t_reference)
    n, h, w, c = feats.shape
    item = feats.element_size()
    calls = []
    if W._windowable(h, w):
        _, sel, y0, x0, s_y, s_x = _windows(feats, warps, masks,
                                            static_empty)
        calls.append(("windows", warps[:, sel], y0[:, sel], x0[:, sel], s_y,
                      s_x, True))
    zero = torch.zeros((n, 1), dtype=torch.int64, device=device)
    calls.append(("full", warps[:, :1], zero, zero, h, w, False))
    rng = np.random.default_rng(1)
    lines = []
    with torch.no_grad():
        for name, wp, yy, xx, s_y, s_x, joint in calls:
            p = wp.shape[1]
            co = W._tap_coeffs(wp, h, w, image_size, yy, xx)
            g = torch.tensor(rng.standard_normal((n, p, s_y, s_x, c)),
                             dtype=torch.float32).to(feats.dtype).to(device)
            ms = time_call(lambda: run(feats, co, s_y, s_x), iters, warmup,
                           device)
            ms_t = time_call(lambda: run_t(g, co, h, w, joint), iters,
                             warmup, device)
            # the plain versions on the same device, once each
            ms_plain = time_call(lambda: WF.warp_taps_reference(
                feats, co, s_y, s_x), 1, 1, device)
            ms_plain_t = time_call(lambda: WF.warp_taps_t_reference(
                g, co, h, w, joint), 1, 1, device)
            diff = (run(feats, co, s_y, s_x).float()
                    - W._warp_win_banded(feats, wp, yy, xx, s_y, s_x,
                                         image_size).float()).abs().max()
            bound = taps_bytes(n, h, w, c, p, s_y, s_x, item, item) / 3.35e9
            bound_t = taps_bytes(n, h, w, c, p, s_y, s_x, item,
                                 4 if joint else item) / 3.35e9
            lines.append({
                "experiment": "ramp", "leg": "taps", "call": name,
                "batch": n, "shape": [h, w, c], "parts": p,
                "window": [s_y, s_x], "joint": joint, "l2": "warm",
                "ms_taps": ms, "ms_taps_t": ms_t,
                "bound_ms_taps": bound, "bound_ms_taps_t": bound_t,
                "roofline_taps": 100 * bound / ms,
                "roofline_taps_t": 100 * bound_t / ms_t,
                "ms_plain": ms_plain, "ms_plain_t": ms_plain_t,
                "max_abs_diff_banded": diff.item(),
                "backend": device.type})
    return lines


def joint(feats, warps, masks, image_size, iters, warmup) -> list[dict]:
    """Where the windowed warp's pass-1 output (natural order (x, p, o, c),
    x the matmul batch) turns into pass 2's (p, o, x, c) batch order:
    inside pass 2's matmul, from a permuted view (production), or as an
    explicit copy before it."""
    device = feats.device
    n, h, w, c = feats.shape
    _, sel, y0, x0, s_y, s_x = _windows(feats, warps, masks)
    p = len(sel)
    wp, yy, xx = warps[:, sel], y0[:, sel], x0[:, sel]

    def variant(copy):
        def call():
            wy, wx = W._two_pass_weights(wp, h, w, image_size, feats.dtype,
                                         yy, xx, s_y, s_x)
            tmp = torch.matmul(wy.reshape(n, w, p * s_y, h),
                               feats.permute(0, 2, 1, 3))
            tmp = tmp.reshape(n, w, p, s_y, c).permute(0, 2, 3, 1, 4)
            return torch.matmul(wx, tmp.contiguous() if copy else tmp)
        return call

    lines = []
    with torch.no_grad():
        for name, copy in (("xpoc view (prod)", False), ("poxc copy", True)):
            ms = time_call(variant(copy), iters, warmup, device)
            lines.append({"experiment": "joint", "variant": name,
                          "batch": n, "ms": ms})
    return lines


def joint_bwd(feats, warps, masks, image_size, iters, warmup) -> list[dict]:
    """The transposed joint pair (``_warp_win_t(joint=True)``): the window
    cotangents' pass-1 output (p, o, x, c) regrouped to pass 2's (x, (p, o))
    batch order, and pass 2's (x, y, c) output handed on as a (y, x, c) view
    (production) or copied to that order."""
    device = feats.device
    n, h, w, c = feats.shape
    _, sel, y0, x0, s_y, s_x = _windows(feats, warps, masks)
    wp, yy, xx = warps[:, sel], y0[:, sel], x0[:, sel]
    rng = np.random.default_rng(1)
    g = torch.tensor(rng.standard_normal((n, len(sel), s_y, s_x, c)),
                     dtype=torch.float32).to(feats.dtype).to(device)

    def variant(copy):
        def call():
            df = W._warp_win_t(g, wp, yy, xx, h, w, image_size, joint=True)
            return df.contiguous() if copy else df
        return call

    lines = []
    with torch.no_grad():
        for name, copy in (("poxc/yxc view (prod)", False),
                           ("poxc/yxc copy", True)):
            ms = time_call(variant(copy), iters, warmup, device)
            lines.append({"experiment": "joint_bwd", "variant": name,
                          "batch": n, "ms": ms})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--pose_dim", type=int, default=18)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--stage", type=int, default=0,
                    help="encoder skip stage (0 = full resolution)")
    ap.add_argument("--mode", choices=("fwd", "grad"), default="grad")
    ap.add_argument("--variant", default="kernel",
                    help="comma list of: full, xla, kernel")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--groups", type=int, default=3,
                    help="part groups for --experiment partstream")
    ap.add_argument("--stream_idx", action="store_true",
                    help="partstream: run both legs with the argmax and "
                         "compare it too")
    ap.add_argument("--caps", default="unset,1024,512,256",
                    help="batchchunk: PT_WARP_PLACE_CHUNK_MB caps in MB "
                         "('unset' = the default 3072), the first the "
                         "reference")
    ap.add_argument("--experiment", default=None,
                    choices=("ramp", "joint", "joint_bwd", "partstream",
                             "batchchunk"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_fold: no CUDA device (pass --device cpu to "
                         "run on the CPU)")
    variants = args.variant.split(",")
    for v in variants:
        if v not in ("full", "xla", "kernel"):
            raise SystemExit(f"bench_fold: unknown variant {v!r}")

    image_size = (args.image_size, args.image_size)
    dtype = DTYPES[args.dtype]
    feats, warps, masks = _fold_inputs(args.batch, image_size,
                                       args.pose_dim, args.stage, dtype,
                                       device)
    exp = {"ramp": ramp, "joint": joint, "joint_bwd": joint_bwd}
    if args.experiment == "partstream":
        lines = partstream(feats, warps, masks, image_size, args.groups,
                           args.stream_idx, args.iters, args.warmup)
    elif args.experiment == "batchchunk":
        settings = [{"PT_WARP_PLACE_CHUNK_MB": None if cap == "unset"
                     else int(cap)} for cap in args.caps.split(",")]
        lines, _ = batchchunk(feats, warps, masks, image_size, settings,
                              args.iters, args.warmup, args.pose_dim)
    elif args.experiment == "ramp":
        lines = ramp(feats, warps, masks, image_size, args.iters,
                     args.warmup, static_empty_parts(args.pose_dim))
    elif args.experiment is not None:
        lines = exp[args.experiment](feats, warps, masks, image_size,
                                     args.iters, args.warmup)
    else:
        h, w, c = _stage_shape(image_size, args.stage)
        lines = []
        for variant in variants:
            call = variant_fold(variant, args.mode, feats, warps, masks,
                                image_size, args.pose_dim)
            ms = time_call(call, args.iters, args.warmup, device)
            lines.append({
                "variant": variant, "mode": args.mode, "ms_per_call": ms,
                "batch": args.batch, "stage": args.stage,
                "shape": [h, w, c], "dtype": args.dtype,
                "backend": device.type})
    name = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    for line in lines:
        print(json.dumps({**line, "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
