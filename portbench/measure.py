"""The benchmark's yardstick arithmetic: the card's peaks, the model FLOPs
of a step from the configuration's shapes, the least bytes of a fold
kernel launch and its least time, the device's idle share over a window,
and latency percentiles that count a failure as a miss.

Nothing here reads the program: the counts come from shapes alone.
"""

from __future__ import annotations

import math

import numpy as np

# NVIDIA H100 SXM data sheet (dense): bf16 tensor cores, f32 outside the
# tensor cores, HBM3
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


# ------------------------------------------------------------ model FLOPs

def gen_convs(image_size, pose_dim: int) -> list[dict]:
    """The generator's convolutions in order: for each, the FLOPs of its
    forward per image (2·outputs·C_in·k², a transposed convolution
    counted over its input pixels) and whether its input needs a
    gradient (not the first convolution of each encoder)."""
    from .reference.model import ladders
    enc, dec = ladders(image_size)
    h, w = image_size
    out = []
    for in_ch in (3 + pose_dim, pose_dim):
        out.append({"flops": 2 * h * w * enc[0] * in_ch * 9, "dgrad": False})
        hh, ww = h, w
        for i in range(1, len(enc)):
            hh, ww = hh // 2, ww // 2
            out.append({"flops": 2 * hh * ww * enc[i] * enc[i - 1] * 16,
                        "dgrad": True})
    hh, ww = h >> (len(enc) - 1), w >> (len(enc) - 1)
    in_ch = 2 * enc[-1]
    for i in range(len(dec) - 1):
        out.append({"flops": 2 * hh * ww * in_ch * dec[i] * 16,
                    "dgrad": True})
        hh, ww = hh * 2, ww * 2
        in_ch = dec[i] + 2 * enc[-(i + 2)]
    out.append({"flops": 2 * h * w * dec[-1] * in_ch * 9, "dgrad": True})
    return out


def disc_convs(image_size, pose_dim: int) -> list[dict]:
    """The discriminator's convolutions (k4 s2: the first VALID, the rest
    padded by 1), FLOPs of the forward per image."""
    h, w = image_size
    out = []
    in_ch = 6 + 2 * pose_dim
    h, w = (h - 4) // 2 + 1, (w - 4) // 2 + 1
    out.append({"flops": 2 * h * w * 64 * in_ch * 16, "dgrad": False})
    prev = 64
    for width in (128, 256, 512, 1):
        h, w = h // 2, w // 2
        out.append({"flops": 2 * h * w * width * prev * 16, "dgrad": True})
        prev = width
    return out


def gen_forward_flops(image_size, pose_dim: int) -> int:
    """Model FLOPs of one generator forward, per image."""
    return sum(c["flops"] for c in gen_convs(image_size, pose_dim))


def train_step_flops(image_size, pose_dim: int, batch: int) -> int:
    """Model FLOPs of one training step (training_ratio 1): the
    discriminator phase (generator forward; discriminator forward,
    weight and input gradients on 2N rows, no input gradient at its first
    layer), then the generator phase (generator forward; discriminator
    forward and input gradients, no weight gradients; the generator's
    weight and input gradients, no input gradient at the encoders' first
    layers). The fold and the elementwise work are not counted."""
    g = gen_convs(image_size, pose_dim)
    d = disc_convs(image_size, pose_dim)
    g_fwd = sum(c["flops"] for c in g)
    g_bwd = sum(c["flops"] * (1 + c["dgrad"]) for c in g)
    d_fwd = sum(c["flops"] for c in d)
    d_wgrad_dgrad = sum(c["flops"] * (1 + c["dgrad"]) for c in d)
    disc_phase = g_fwd + 2 * d_fwd + 2 * d_wgrad_dgrad
    gen_phase = g_fwd + d_fwd + d_fwd + g_bwd
    return batch * (disc_phase + gen_phase)


def content_flops(image_size, layer: str, batch: int) -> int:
    """Model FLOPs that a content loss at VGG19 ``layer`` adds to a
    training step ('none': 0): the VGG19 prefix's convolutions forward on
    the generated and the target images, and the input gradient on the
    generated one (the filters are frozen: no weight gradient)."""
    if layer == "none":
        return 0
    from .reference.content import layer_index, layout
    h, w = image_size
    per_image = 0
    for kind, in_ch, out_ch in layout()[:layer_index(layer) + 1]:
        if kind == "conv":
            per_image += 2 * h * w * out_ch * in_ch * 9
        elif kind == "pool":
            h, w = h // 2, w // 2
    return 3 * batch * per_image


def mfu(flops: float, seconds: float) -> float:
    """Share of the bf16 dense peak, %."""
    return 100.0 * flops / seconds / BF16_FLOPS


# ------------------------------------------------------ fold kernel bounds

def place_bytes(n, h, w, c, p, sy, sx, itemsize, emit_idx) -> int:
    """Least bytes of one ``fold_place`` launch: the body read and the
    output written, the window warps and mask windows read once, the
    zero-pass flags and offsets, and the int8 argmax written when
    emitted."""
    b = itemsize * (2 * n * h * w * c + n * p * sy * sx * c + n * p * sy * sx)
    b += n * h * w + n * p * 3 * 4
    return b + (n * h * w * c if emit_idx else 0)


def route_bytes(n, h, w, c, p, sy, sx, itemsize) -> int:
    """Least bytes of one ``fold_route`` launch: the cotangent read and the
    body route written, the window cotangents written, the mask windows
    and the body mask read once, the int8 argmax read, the offsets."""
    return itemsize * (2 * n * h * w * c + n * p * sy * sx * c
                       + n * p * sy * sx + n * h * w) \
        + n * h * w * c + 12 * n * p


def fold_ops(n, p, sy, sx, c) -> int:
    """Operations of either kernel: a multiply and a compare-select per
    window element."""
    return 2 * n * p * sy * sx * c


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time a launch can take on the card: bytes at the HBM
    rate or operations at the f32 rate, whichever binds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def _least(rec) -> float:
    kernel, n, h, w, c, p, sy, sx, itemsize, emit_idx = rec
    nbytes = place_bytes(n, h, w, c, p, sy, sx, itemsize, emit_idx) \
        if kernel == "fold_place" else \
        route_bytes(n, h, w, c, p, sy, sx, itemsize)
    return least_seconds(nbytes, fold_ops(n, p, sy, sx, c))


def fold_roofline(trace, records, kernel: str):
    """Σ least time of the ``kernel`` launches in ``trace`` over Σ their
    device time, %. A launch's shape is the benchmark's record of its
    call: records and trace matched in order where they count alike (one
    thread launching, the window synchronised at both ends), or the one
    shape every record shares (a server whose batcher runs on past the
    window's ends). None without a trace or launches, or when neither
    holds."""
    if trace is None or not records:
        return None
    recs = [r for r in records if r[0] == kernel]
    durations = [e - s for _, s, e in trace.kernels(kernel, unless="stream")]
    if not recs or not durations:
        return None
    if len(recs) == len(durations):
        least = sum(_least(r) for r in recs)
    elif len(set(recs)) == 1:
        least = len(durations) * _least(recs[0])
    else:
        return None
    return 100.0 * least / (sum(durations) / 1e9)


# ---------------------------------------------------------------- device

def busy_seconds(intervals, start: float, end: float) -> float:
    """Length of the union of (start, end) intervals, clipped to the
    window [start, end] (any time unit)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(intervals, start: float, end: float) -> list[tuple]:
    """(gap start, gap end) of the window not covered by any interval,
    the head and the tail included."""
    gaps, cur = [], start
    for s, e in sorted(intervals):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if end > cur:
        gaps.append((cur, end))
    return gaps


def idle_share(intervals, start: float, end: float) -> float:
    """1 − busy / window, %."""
    return 100.0 * (1.0 - busy_seconds(intervals, start, end) / (end - start))


# --------------------------------------------------------------- latency

def percentile_ms(latencies_s, q: float) -> float:
    """The q-th percentile by nearest rank (the ceil(q/100 · n)-th
    smallest) of latencies in seconds, in ms; a failed or unanswered
    request is +inf and so lands beyond every finite latency."""
    lat = np.sort(np.asarray(latencies_s, np.float64))
    if lat.size == 0:
        return math.inf
    rank = max(1, math.ceil(q / 100.0 * lat.size))
    return float(lat[rank - 1]) * 1e3

