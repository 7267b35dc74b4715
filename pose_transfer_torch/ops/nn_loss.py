"""Nearest-neighbour reconstruction distance, forward only.

Counterpart of the forward of ``pose_transfer_tpu/ops/nn_loss.py``
(``_nn_loss_primal``): per output pixel, the L1 distance (summed over
channels) to the best-matching ground-truth pixel within an (nh, nw)
neighbourhood, averaged over all pixels; the min runs as an unrolled
accumulator over the shifts. Kept from the reference: the swapped pad-axis
convention (``nw // 2`` rows on the height axis, ``nh // 2`` columns on the
width axis; immaterial where nh == nw) and the -10000 pad.

The evaluation needs no gradient. The argmin-routed backward comes with
content-loss training (ROADMAP.md §A item 6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nn_loss(predicted: torch.Tensor, ground_truth: torch.Tensor,
            nh: int = 3, nw: int = 3) -> torch.Tensor:
    """Min-over-neighbourhood L1 between NHWC feature maps (0-d tensor).
    ``nh == nw == 1`` is the channel-summed L1 mean."""
    v_pad, h_pad = nh // 2, nw // 2
    gt_pad = F.pad(ground_truth, (0, 0, v_pad, v_pad, h_pad, h_pad),
                   value=-10000.0)
    _, h, w, _ = predicted.shape
    min_norms = None
    for i in range(nh):
        for j in range(nw):
            ref = gt_pad[:, i:i + h, j:j + w, :]
            norms = (ref - predicted).abs().sum(dim=-1)
            min_norms = norms if min_norms is None \
                else torch.minimum(min_norms, norms)
    return min_norms.mean()
