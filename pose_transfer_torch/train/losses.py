"""GAN losses with the reference's exact scaling.

Counterpart of ``pose_transfer_tpu/train/losses.py``:
- generator adversarial: ``gan_w/batch · Σ_i mean_patches(-log(D_i + EPS))``;
- discriminator: true rows ``-log(D + EPS)``, fake rows
  ``-log(1 - D + EPS)``, each summed over per-sample means and scaled
  ``gan_w/batch``;
- reconstruction: the mean absolute error (L1);
- total variation (the optional TV penalty).

Every reduction runs in float32 whatever the compute dtype: probabilities
are upcast before the +EPS and the log (in bf16 the EPS vanishes against 1).
"""

from __future__ import annotations

import torch

EPS = 1e-7


def gen_adversarial_loss(disc_out_fake: torch.Tensor, gan_weight: float,
                         batch_size: int) -> torch.Tensor:
    """Saturating log-loss toward 'real' on the generator's samples."""
    per_sample = (-torch.log(disc_out_fake.float() + EPS)).mean(dim=-1)
    return per_sample.sum() * gan_weight / batch_size


def disc_adversarial_loss(disc_out_real: torch.Tensor,
                          disc_out_fake: torch.Tensor, gan_weight: float,
                          batch_size: int):
    """(true_loss, fake_loss) with the reference's per-side scaling."""
    true_loss = (-torch.log(disc_out_real.float() + EPS)).mean(dim=-1) \
        .sum() * gan_weight / batch_size
    fake_loss = (-torch.log(1.0 - disc_out_fake.float() + EPS)) \
        .mean(dim=-1).sum() * gan_weight / batch_size
    return true_loss, fake_loss


def l1_loss(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over all elements (torch.nn.L1Loss's default)."""
    return (predicted.float() - target.float()).abs().mean()


def total_variation_loss(x: torch.Tensor) -> torch.Tensor:
    """Mean absolute vertical plus horizontal difference of an NHWC map."""
    x = x.float()
    dy = (x[:, 1:, :, :] - x[:, :-1, :, :]).abs()
    dx = (x[:, :, 1:, :] - x[:, :, :-1, :]).abs()
    return dy.mean() + dx.mean()
