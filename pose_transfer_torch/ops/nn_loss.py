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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


class NNLoss(torch.autograd.Function):
    """``nn_loss`` with the argmin-routed backward. Saved: the two inputs
    and one uint8 (N, H, W) shift index, nothing per shift."""

    @staticmethod
    def forward(ctx, predicted, ground_truth, nh, nw):
        if nh * nw > 256:
            raise ValueError(f"a {nh}x{nw} area has more shifts than a "
                             "uint8 index holds")
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
        ctx.save_for_backward(predicted, ground_truth, idx)
        ctx.area = (nh, nw)
        return min_norms.mean()

    @staticmethod
    def backward(ctx, g):
        predicted, ground_truth, idx = ctx.saved_tensors
        nh, nw = ctx.area
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
        if ctx.needs_input_grad[1]:
            # the signs scattered back to the windows they came from (sums
            # of ±1 in f32: exact in any order), then cropped as padded
            acc = torch.zeros((n, hp * wp, c), dtype=torch.float32,
                              device=sign.device).scatter_add_(1, src, sign)
            v_pad, h_pad = nh // 2, nw // 2
            d_gt = (scale * acc.reshape(n, hp, wp, c)[
                :, h_pad:h_pad + h, v_pad:v_pad + w]).to(ground_truth.dtype)
        return d_pred, d_gt, None, None


def nn_loss(predicted: torch.Tensor, ground_truth: torch.Tensor,
            nh: int = 3, nw: int = 3) -> torch.Tensor:
    """Min-over-neighbourhood L1 between NHWC feature maps (0-d tensor).
    ``nh == nw == 1`` is the channel-summed L1 mean."""
    return NNLoss.apply(predicted, ground_truth, nh, nw)
