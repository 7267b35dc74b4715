"""The content loss's kernels in a traced window: the least bytes and
operations of an ``nn_loss`` launch, the shape every launch of a cell has
(from its configuration and its mix), and the readers' arithmetic over
the trace's ``nn_loss`` kernels (``csrc/nn_loss.cu``: the forward's names
hold ``nn_loss_fwd``, the backward's ``nn_loss_bwd``).

Nothing here reads the program: the counts come from shapes alone. A
program without the kernels (the content path op by op) leaves no such
launch in its trace, and every reader here returns None for it.
"""

from __future__ import annotations

from . import measure
from .reference.content import layer_index, layout

KERNEL = "nn_loss"
DIRECTIONS = ("fwd", "bwd")


def nn_loss_bytes(n, h, w, c, direction: str, reached: int = 0) -> int:
    """Least bytes of one launch on f32 maps with a uint8 index: the
    forward reads both maps once and writes the index (the loss is one
    float); the backward reads the prediction and the index, writes the
    prediction's cotangent, and reads the ``reached`` target pixels that
    the index points at inside the map. How many that is depends on the
    data (37.7 % of the target's pixels on the cell's features, on an
    H100: several pixels pick the same neighbour), and the shape alone
    cannot say: the readers here count none, so the backward's share is
    never overstated. (Counting the whole target, 3·N·H·W·C·4 + N·H·W,
    read 109 % for the backward alone.)"""
    if direction == "fwd":
        return 2 * n * h * w * c * 4 + n * h * w
    return (2 * n * h * w + reached) * c * 4 + n * h * w


def nn_loss_ops(n, h, w, c, area: int, direction: str) -> int:
    """Operations of one launch: the forward a subtract, an abs and an add
    per channel, shift and pixel; the backward a subtract and a multiply
    per element."""
    if direction == "fwd":
        return 3 * area * area * n * h * w * c
    return 2 * n * h * w * c


def cell_shape(config: dict, batch: int) -> tuple | None:
    """(N, H, W, C, area) of the content features at the configuration's
    content layer and the mix's batch; None without a content layer."""
    layer = config.get("content_loss_layer", "none")
    if layer == "none":
        return None
    h, w = config["image_size"]
    c = 3
    for kind, _, out_ch in layout()[:layer_index(layer) + 1]:
        if kind == "conv":
            c = out_ch
        elif kind == "pool":
            h, w = h // 2, w // 2
    return batch, h, w, c, config["nn_loss_area_size"]


def least_seconds(shape: tuple, direction: str) -> float:
    n, h, w, c, area = shape
    return measure.least_seconds(nn_loss_bytes(n, h, w, c, direction),
                                 nn_loss_ops(n, h, w, c, area, direction))


def launches(trace) -> dict:
    """{direction: [device ns of each launch]} of the window's nn_loss
    kernels."""
    return {d: [e - s for _, s, e in trace.kernels(f"{KERNEL}_{d}")]
            for d in DIRECTIONS}


def roofline(trace, shape) -> float | None:
    """Σ least time of the window's nn_loss launches (every launch of the
    cell at ``shape``) over Σ their device time, %; None without a trace,
    a shape or a launch."""
    if trace is None or shape is None:
        return None
    got = launches(trace)
    total_ns = sum(sum(v) for v in got.values())
    if not total_ns:
        return None
    least = sum(len(got[d]) * least_seconds(shape, d) for d in DIRECTIONS)
    return 100.0 * least / (total_ns / 1e9)


def device_ms(trace) -> float | None:
    """Device ms of the window's nn_loss launches; None without a trace
    or a launch."""
    if trace is None:
        return None
    total_ns = sum(sum(v) for v in launches(trace).values())
    return total_ns / 1e6 if total_ns else None
