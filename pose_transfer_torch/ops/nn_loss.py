"""Nearest-neighbour reconstruction distance (``--nn_loss_area_size``).

Counterpart of ``pose_transfer_tpu/ops/nn_loss.py``: per output pixel, the
L1 distance (summed over channels) to the best-matching ground-truth pixel
within an (nh, nw) neighbourhood, averaged over all pixels; the min runs as
an unrolled accumulator over the shifts. Kept from the reference: the
swapped pad-axis convention (``nw // 2`` rows on the height axis,
``nh // 2`` columns on the width axis; immaterial where nh == nw) and the
-10000 pad.

The gradient is argmin-routed (``NNLoss``), as the JAX package's custom
VJP: autograd through the chain of ``minimum``s would keep every shift's
norm map and difference tensor (at area 5, 25 of each), where the backward
reads them only through the per-pixel argmin. The forward stores one uint8
shift index beside the two inputs; the backward gathers each pixel's
winning reference through it and regenerates sign(ref − pred) in one pass
(the JAX package masks the nh·nw shifts in turn: the same values). At ties
the first shift in scan order wins (a strict ``<`` update).

On a CUDA tensor both directions run the hand-written kernels of
``csrc/nn_loss.cu`` (built by ``pose_transfer_torch._build``): the forward
in one pass over both maps, with the pad virtual (no padded copy), the
index and the mean in the same launch; the prediction's cotangent in one
pass from the saved index. They take float32 maps with C % 4 == 0 and
raise on anything else; no path falls back from the kernels to the plain
code. A CPU tensor takes the plain code, which stays the tests' oracle.
The kernels sum a pixel's channels in another order than the plain code,
so a norm may differ in its last bits and, where two shifts' norms lie
that close, the index may pick the other one; the loss agrees to f32
rounding. The target's cotangent (asked for by no training step) stays on
the plain scatter. ``LAUNCHES`` counts the kernels' launches (registered
with ``ops.launches``).

Spans (``utils.spans``, while a profiler records): ``content.nn_loss``
around the forward, ``content.nn_loss.bwd`` around the backward (on
autograd's device thread), each with the attribute ``area``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.spans import span
from .launches import count_launch, kernel_lib, launch, register

LAUNCHES = register({"nn_loss_fwd": 0, "nn_loss_bwd": 0})
MAX_SHIFTS = 256                  # a uint8 index


def _shifts(nh: int, nw: int):
    return [(i, j) for i in range(nh) for j in range(nw)]


def _pad_gt(ground_truth: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    # F.pad pads the last axis first: channels none, width nh // 2, height
    # nw // 2 (the reference's swapped convention)
    v_pad, h_pad = nh // 2, nw // 2
    return F.pad(ground_truth, (0, 0, v_pad, v_pad, h_pad, h_pad),
                 value=-10000.0)


def nn_loss_reference(predicted: torch.Tensor, ground_truth: torch.Tensor,
                      nh: int = 3, nw: int = 3) -> torch.Tensor:
    """The plain primal (a chain of ``minimum``s); autograd through it keeps
    every shift's residuals. The tests and ``chip_smoke.py`` hold
    ``NNLoss``'s gradient to it."""
    gt_pad = _pad_gt(ground_truth, nh, nw)
    _, h, w, _ = predicted.shape
    min_norms = None
    for i, j in _shifts(nh, nw):
        ref = gt_pad[:, i:i + h, j:j + w, :]
        norms = (ref - predicted).abs().sum(dim=-1)
        min_norms = norms if min_norms is None \
            else torch.minimum(min_norms, norms)
    return min_norms.mean()


def _check_area(nh: int, nw: int) -> None:
    if nh * nw > MAX_SHIFTS:
        raise ValueError(f"a {nh}x{nw} area has more shifts than a "
                         "uint8 index holds")
    if nh - 1 > 2 * (nw // 2) or nw - 1 > 2 * (nh // 2):
        raise ValueError(f"a {nh}x{nw} area's windows leave the padded "
                         "target (the pad is nw // 2 rows, nh // 2 columns)")


def _forward_plain(predicted, ground_truth, nh, nw):
    """(loss, uint8 (N, H, W) shift index): the shifts in turn on a padded
    copy of the target."""
    gt_pad = _pad_gt(ground_truth, nh, nw)
    _, h, w, _ = predicted.shape
    min_norms = idx = None
    for k, (i, j) in enumerate(_shifts(nh, nw)):
        ref = gt_pad[:, i:i + h, j:j + w, :]
        norms = (ref - predicted).abs().sum(dim=-1)
        if min_norms is None:
            min_norms = norms
            idx = torch.zeros(norms.shape, dtype=torch.uint8,
                              device=norms.device)
        else:
            take = norms < min_norms          # strict: first shift wins
            min_norms = torch.where(take, norms, min_norms)
            idx = torch.where(take, k, idx).to(torch.uint8)
    return min_norms.mean(), idx


def _backward_plain(predicted, ground_truth, idx, g, nh, nw, want_gt):
    """(d_pred, d_gt or None) from the saved index."""
    gt_pad = _pad_gt(ground_truth, nh, nw)
    n, h, w, c = predicted.shape
    hp, wp = gt_pad.shape[1:3]
    # pixel (y, x) won at shift k = i·nw + j, whose window reads row
    # y + i, column x + j of the padded target: gather that reference
    # (one pass, where the JAX package masks each of the nh·nw shifts)
    k = idx.long()
    rows = torch.arange(h, device=k.device)[:, None] + k // nw
    cols = torch.arange(w, device=k.device)[None, :] + k % nw
    src = (rows * wp + cols).reshape(n, h * w, 1).expand(n, h * w, c)
    ref = gt_pad.reshape(n, hp * wp, c).gather(1, src)
    # d|ref − pred|/dpred = −sign(ref − pred); sign(0) = 0, as
    # autograd's abs rule. In f32: the signs are exact, and the small
    # scale g/(N·H·W) is applied once
    sign = torch.sign(ref.float() - predicted.reshape(n, h * w, c).float())
    scale = g.float() / (n * h * w)
    d_pred = (-scale * sign).reshape(predicted.shape).to(predicted.dtype)
    d_gt = None
    if want_gt:
        # the signs scattered back to the windows they came from (sums
        # of ±1 in f32: exact in any order), then cropped as padded
        acc = torch.zeros((n, hp * wp, c), dtype=torch.float32,
                          device=sign.device).scatter_add_(1, src, sign)
        v_pad, h_pad = nh // 2, nw // 2
        d_gt = (scale * acc.reshape(n, hp, wp, c)[
            :, h_pad:h_pad + h, v_pad:v_pad + w]).to(ground_truth.dtype)
    return d_pred, d_gt


def _on_card(predicted: torch.Tensor, ground_truth: torch.Tensor) -> bool:
    """Whether the kernels run (CUDA) or the plain code (CPU); raises on
    inputs the kernels do not take."""
    dev = predicted.device
    if dev.type == "cpu":
        if ground_truth.device.type != "cpu":
            raise ValueError("nn_loss: tensors on different devices")
        return False
    if dev.type != "cuda" or ground_truth.device != dev:
        raise ValueError("nn_loss: both maps must be on one CUDA device")
    if predicted.dtype != torch.float32 \
            or ground_truth.dtype != torch.float32:
        raise TypeError("nn_loss: the kernels take float32 maps, got "
                        f"{predicted.dtype} and {ground_truth.dtype}")
    if predicted.ndim != 4 or predicted.shape != ground_truth.shape:
        raise ValueError("nn_loss: needs two (N, H, W, C) maps of one "
                         f"shape, got {tuple(predicted.shape)} and "
                         f"{tuple(ground_truth.shape)}")
    if predicted.shape[-1] % 4:
        raise ValueError(f"nn_loss: needs C % 4 == 0, got "
                         f"C={predicted.shape[-1]}")
    return True


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels' float4 loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lib(entry: str, n_ptrs: int) -> ctypes.CDLL:
    lib = kernel_lib("nn_loss", n_ptrs, 6, entry)
    if lib.nn_loss_fwd_blocks.argtypes is None:
        lib.nn_loss_fwd_blocks.restype = ctypes.c_int
        lib.nn_loss_fwd_blocks.argtypes = [ctypes.c_int] * 6
    return lib


def nn_loss_fwd(predicted: torch.Tensor, ground_truth: torch.Tensor,
                nh: int, nw: int):
    """The forward kernel on dense f32 CUDA maps → (0-d f32 loss, uint8
    (N, H, W) shift index)."""
    n, h, w, c = predicted.shape
    dev = predicted.device
    lib = _lib("nn_loss_fwd", 6)
    blocks = lib.nn_loss_fwd_blocks(n, h, w, c, nh, nw)
    idx = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    partial = torch.empty((blocks,), dtype=torch.float64, device=dev)
    count = torch.zeros((1,), dtype=torch.int32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    launch("nn_loss_fwd", lib, dev, predicted.data_ptr(),
           ground_truth.data_ptr(), idx.data_ptr(), partial.data_ptr(),
           count.data_ptr(), loss.data_ptr(), n, h, w, c, nh, nw,
           source="nn_loss")
    count_launch(LAUNCHES, "nn_loss_fwd")
    return loss, idx


def nn_loss_bwd(predicted: torch.Tensor, ground_truth: torch.Tensor,
                idx: torch.Tensor, scale: torch.Tensor, nh: int,
                nw: int) -> torch.Tensor:
    """The prediction's cotangent kernel: (−scale)·sign(ref − pred) at each
    pixel's saved shift, ``scale`` a 0-d f32 CUDA tensor (g / (N·H·W))."""
    n, h, w, c = predicted.shape
    d_pred = torch.empty_like(predicted)
    lib = _lib("nn_loss_bwd", 5)
    launch("nn_loss_bwd", lib, predicted.device, predicted.data_ptr(),
           ground_truth.data_ptr(), idx.data_ptr(), scale.data_ptr(),
           d_pred.data_ptr(), n, h, w, c, nh, nw, source="nn_loss")
    count_launch(LAUNCHES, "nn_loss_bwd")
    return d_pred


class NNLoss(torch.autograd.Function):
    """``nn_loss`` with the argmin-routed backward. Saved: the two inputs
    and one uint8 (N, H, W) shift index, nothing per shift."""

    @staticmethod
    def forward(ctx, predicted, ground_truth, nh, nw):
        _check_area(nh, nw)
        if _on_card(predicted, ground_truth):
            predicted, ground_truth = _dense(predicted), _dense(ground_truth)
            loss, idx = nn_loss_fwd(predicted, ground_truth, nh, nw)
        else:
            loss, idx = _forward_plain(predicted, ground_truth, nh, nw)
        ctx.save_for_backward(predicted, ground_truth, idx)
        ctx.area = (nh, nw)
        return loss

    @staticmethod
    def backward(ctx, g):
        predicted, ground_truth, idx = ctx.saved_tensors
        nh, nw = ctx.area
        want_gt = ctx.needs_input_grad[1]
        with span("content.nn_loss.bwd", area=f"{nh}x{nw}"):
            if predicted.device.type != "cuda":
                d_pred, d_gt = _backward_plain(predicted, ground_truth, idx,
                                               g, nh, nw, want_gt)
                return d_pred, d_gt, None, None
            n, h, w, _ = predicted.shape
            # the plain backward's own op, so that the scale is its bits
            scale = g.float() / (n * h * w)
            d_pred = nn_loss_bwd(predicted, ground_truth, idx, scale, nh, nw)
            d_gt = _backward_plain(predicted, ground_truth, idx, g, nh, nw,
                                   True)[1] if want_gt else None
        return d_pred, d_gt, None, None


def nn_loss(predicted: torch.Tensor, ground_truth: torch.Tensor,
            nh: int = 3, nw: int = 3) -> torch.Tensor:
    """Min-over-neighbourhood L1 between NHWC feature maps (0-d tensor).
    ``nh == nw == 1`` is the channel-summed L1 mean."""
    with span("content.nn_loss", area=f"{nh}x{nw}"):
        return NNLoss.apply(predicted, ground_truth, nh, nw)
