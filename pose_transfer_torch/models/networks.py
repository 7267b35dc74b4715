"""The generators (deformable, stacked, plain U-Net) and the patch
discriminator (PyTorch modules).

Counterpart of ``Block``, ``Encoder``, ``Decoder``, ``DeformableGenerator``,
``StackedGenerator``, ``UNetGenerator``, ``Discriminator`` and
``gaussian_weights_init`` in ``pose_transfer_tpu/models/networks.py``.

Module attribute names reproduce the reference PyTorch state_dict names
(the keys ``pose_transfer_tpu/models/import_torch.py`` maps), so a
reference checkpoint loads with ``load_state_dict`` as it is:
  encoder_app.net.0.{weight,bias}             full-res k3 conv
  encoder_app.net.{i}.net.1.weight            Block conv (i ≥ 1)
  encoder_app.net.{i}.net.2.{weight,bias}     Block volume norm
  decoder.net.{i}.net.1.weight                Block transposed conv
  decoder.net.{i}.net.3.{weight,bias}         Block volume norm
  decoder.net.{n}.{weight,bias}               final k3 conv
  (discriminator) net.0.{weight,bias}         k4s2 VALID conv
  (discriminator) net.{i}.net.{1,2}.*         Block conv / norm (i ≥ 1)
The stacked generator holds the same keys under ``generator.`` (the
reference's prefix); the U-Net has ``encoder.*`` and ``decoder.*``.

Parameters are float32; ``dtype`` is the compute dtype (convolutions cast
their weights to it, the norm computes in f32 and rounds back), as flax's
``dtype`` does. The public layout is NHWC; inside, the convolution stacks
run NCHW views of ``channels_last`` tensors, so the permutes at the
boundary are views.

Spans (``utils.spans``, while a profiler records): ``gen.encoder_app``,
``gen.encoder_pose`` and ``gen.decoder`` in the deformable generator's
forward (every stage of the stacked one), ``gen.encoder`` and
``gen.decoder`` in the U-Net's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core import pose as pose_ops
from ..core import transforms_host as th
from ..ops.norm import volume_instance_norm
from ..ops.warp import (affine_transform_layer, check_backend, check_place,
                        plan_folds)
from ..utils.spans import span


def encoder_filters_for(image_size: tuple[int, int]) -> tuple[int, ...]:
    """Filter ladder selection (reference pose_gan.py)."""
    if max(image_size) < 256:
        return (64, 128, 256, 512, 512, 512)
    return (64, 128, 256, 512, 512, 512, 512)


def decoder_filters_for(image_size: tuple[int, int]) -> tuple[int, ...]:
    if max(image_size) < 256:
        return (512, 512, 512, 256, 128, 3)
    return (512, 512, 512, 512, 256, 128, 3)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype (f32 parameters)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """k4s2 ``nn.ConvTranspose2d`` with padding 1 — the reference's VALID
    transposed conv followed by a crop of 1 — in the input's dtype."""

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None,
                                  self.stride, self.padding)


class VolumeInstanceNorm(nn.Module):
    """Scalar-affine whole-volume instance norm (InstanceNorm3d(1) on the
    (N, 1, C, H, W) view): weight/bias of shape (1,)."""

    def __init__(self, eps: float = 1e-3, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(1, device=device))
        self.bias = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x):
        return volume_instance_norm(x, self.weight, self.bias, self.eps)


class ChannelDropout(nn.Module):
    """Dropout2d: whole (sample, channel) planes dropped with probability
    ``p``, kept ones scaled by 1/(1-p) — flax's ``Dropout(p,
    broadcast_dims=(1, 2))``. In training mode it draws from
    ``generator`` (the train step hands it the state's generator; None
    means the global one). ``shard`` = (rank, world): the data-parallel
    step's rank r of k holds rows r·n..(r+1)·n of the global batch, so it
    draws the global batch's (k·n, C) planes and keeps its rows, and k
    ranks drop what one device drops. No parameters: state_dicts are
    unchanged."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None
        self.shard = (0, 1)

    def forward(self, x):          # x: NCHW
        if not self.training:
            return x
        n, c = x.shape[:2]
        rank, world = self.shard
        keep = torch.rand((n * world, c, 1, 1), generator=self.generator,
                          device=x.device)[rank * n:(rank + 1) * n] >= self.p
        return torch.where(keep, x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class Block(nn.Module):
    """Down: LeakyReLU(0.2) → k4s2p1 conv → norm.
    Up: ReLU → k4s2 transposed conv (+crop 1) → norm → channel dropout 0.5.
    ``net`` indices follow the reference's Sequential."""

    def __init__(self, in_ch: int, out_ch: int, down: bool = True,
                 bn: bool = True, dropout: bool = False, device=None):
        super().__init__()
        if down:
            layers = [nn.LeakyReLU(0.2),
                      Conv2d(in_ch, out_ch, 4, 2, 1, bias=False,
                             device=device)]
        else:
            layers = [nn.ReLU(),
                      ConvTranspose2d(in_ch, out_ch, 4, 2, 1, bias=False,
                                      device=device),
                      nn.Identity()]        # the reference's crop slot
        if bn:
            layers.append(VolumeInstanceNorm(device=device))
        if dropout:
            layers.append(ChannelDropout(0.5))
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(x)


class Encoder(nn.Module):
    """Shared U-Net encoder; returns every stage output (NCHW) as a skip."""

    def __init__(self, in_ch: int, nfilters: Sequence[int], device=None):
        super().__init__()
        layers = [Conv2d(in_ch, nfilters[0], 3, 1, 1, device=device)]
        for i in range(1, len(nfilters)):
            layers.append(Block(nfilters[i - 1], nfilters[i],
                                bn=(i != len(nfilters) - 1), device=device))
        self.net = nn.ModuleList(layers)

    def forward(self, x):
        outputs = []
        for layer in self.net:
            x = layer(x)
            outputs.append(x)
        return outputs


class Decoder(nn.Module):
    """U-Net decoder over skip-concats: up Blocks (dropout on the first 3),
    then ReLU → k3 conv → tanh. A skip is ``num_skips`` encoder outputs
    wide: 2 in the deformable generator ([warped appearance ‖ pose]), 1 in
    the U-Net."""

    def __init__(self, nfilters_dec: Sequence[int],
                 nfilters_enc: Sequence[int], num_skips: int = 2,
                 device=None):
        super().__init__()
        n = len(nfilters_dec)
        layers = []
        in_ch = num_skips * nfilters_enc[-1]
        for i in range(n - 1):
            layers.append(Block(in_ch, nfilters_dec[i], down=False,
                                dropout=(i < 3), device=device))
            in_ch = nfilters_dec[i] + num_skips * nfilters_enc[-(i + 2)]
        layers.append(nn.ReLU())
        layers.append(Conv2d(in_ch, nfilters_dec[-1], 3, 1, 1,
                             device=device))
        self.net = nn.ModuleList(layers)

    def forward(self, skips):
        n = len(self.net) - 1            # blocks + ReLU
        out = self.net[0](skips[-1])
        for i in range(1, n - 1):
            out = self.net[i](torch.cat([out, skips[-(i + 1)]], dim=1))
        out = torch.cat([out, skips[-n]], dim=1)
        out = self.net[n](self.net[n - 1](out))
        return torch.tanh(out)


class DeformableGenerator(nn.Module):
    """Dual-encoder U-Net with deformable (affine-warped) skips.

    ``forward(inp, warps, masks)``: inp (N, H, W, 3+2K) packed input,
    warps (N, T, 8), masks (N, T, H, W) or None → (N, H, W, 3) in [-1, 1].
    The appearance skips of the first ``num_warp_stages`` stages go
    through ``affine_transform_layer``; ``warp_backend`` 'pallas' sends the
    stages the fused warp fold supports to it (``ops/warp_pallas.py``),
    'exact' every stage to the gather-bilinear fold;
    ``warp_place`` ('auto' | 'kernel' | 'xla') chooses the windowed fold's
    placement (``ops.warp.plan_folds``).
    """

    def __init__(self, pose_dim: int, image_size: tuple[int, int],
                 nfilters_enc: Sequence[int], nfilters_dec: Sequence[int],
                 warp_skip: str = "mask", warp_agg: str = "max",
                 use_input_pose: bool = True, num_warp_stages: int = 4,
                 warp_windowed: bool = False, warp_backend: str = "matmul",
                 warp_place: str = "auto",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        check_backend(warp_backend)
        check_place(warp_place)
        self.pose_dim = pose_dim
        self.image_size = tuple(image_size)
        self.warp_skip = warp_skip
        self.warp_agg = warp_agg
        self.use_input_pose = use_input_pose
        self.num_warp_stages = num_warp_stages
        self.warp_windowed = warp_windowed
        self.warp_backend = warp_backend
        self.warp_place = warp_place
        self.dtype = dtype
        # without the input pose the packed input is [image ‖ target pose]
        # and get_imgpose's target slice starts at 6: K - 3 channels
        app_ch = 3 + pose_dim if use_input_pose else 3
        pose_ch = pose_dim if use_input_pose else pose_dim - 3
        self.encoder_app = Encoder(app_ch, nfilters_enc, device=device)
        self.encoder_pose = Encoder(pose_ch, nfilters_enc, device=device)
        self.decoder = Decoder(nfilters_dec, nfilters_enc, device=device)

    def forward(self, inp, warps, masks):
        def nchw(x):   # NHWC tensor → NCHW view with channels_last strides
            return x.permute(0, 3, 1, 2)

        inp = inp.to(self.dtype).contiguous()
        inp_img, inp_pose, tg_pose = pose_ops.get_imgpose(
            inp, self.use_input_pose, self.pose_dim)
        inp_app = torch.cat([inp_img, inp_pose], dim=-1) \
            if inp_pose is not None else inp_img
        with span("gen.encoder_app"):
            skips_app = self.encoder_app(nchw(inp_app.contiguous()))
        with span("gen.encoder_pose"):
            skips_pose = self.encoder_pose(nchw(tg_pose.contiguous()))

        # parts whose joints don't exist in this schema are empty for EVERY
        # sample (pose_dim 16: head + 4 knee-adjacent limbs)
        static_empty = th.static_empty_parts(self.pose_dim) \
            if self.warp_skip == "mask" else ()
        n_warp = min(self.num_warp_stages, len(skips_app))
        feats = [s.permute(0, 2, 3, 1).contiguous()
                 for s in skips_app[:n_warp]]
        warps = warps.to(self.dtype)
        plans = plan_folds([tuple(f.shape) for f in feats], warps, masks,
                           self.dtype, self.warp_skip, self.warp_agg,
                           self.warp_windowed, static_empty,
                           self.warp_backend, self.warp_place)
        skips = []
        for i, (sk_app, sk_pose) in enumerate(zip(skips_app, skips_pose)):
            if i < n_warp:
                warped = affine_transform_layer(
                    feats[i], warps, masks, self.image_size, self.warp_skip,
                    self.warp_agg, self.warp_windowed, static_empty,
                    plan=plans[i])
                sk_app = nchw(warped)
            skips.append(torch.cat([sk_app, sk_pose], dim=1))
        with span("gen.decoder"):
            return self.decoder(skips).permute(0, 2, 3, 1)


class UNetGenerator(nn.Module):
    """The plain single-encoder U-Net (the reference's baseline tree): the
    packed input through one ``Encoder``, its outputs as the skips, no
    warping. ``forward(inp)``: (N, H, W, 3+2K) → (N, H, W, 3)."""

    def __init__(self, in_ch: int, nfilters_enc: Sequence[int],
                 nfilters_dec: Sequence[int],
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.encoder = Encoder(in_ch, nfilters_enc, device=device)
        self.decoder = Decoder(nfilters_dec, nfilters_enc, num_skips=1,
                               device=device)

    def forward(self, inp):
        x = inp.to(self.dtype).contiguous().permute(0, 3, 1, 2)
        with span("gen.encoder"):
            skips = self.encoder(x)
        with span("gen.decoder"):
            return self.decoder(skips).permute(0, 2, 3, 1)


class StackedGenerator(nn.Module):
    """One shared ``DeformableGenerator`` (``generator``) applied
    ``num_stacks`` times along the interpolated-pose chain.

    ``forward(inp, target_pose, target_warps, target_masks)``: inp (N, H,
    W, 3+2K) packed input, target_pose (N, H, W, S·K) the stages' target
    heatmaps, target_warps (N, S+1, T, 8), target_masks (N, S+1, T, H, W)
    or None → the list of the S stages' (N, H, W, 3) images. Stage 0 takes
    [source image ‖ source pose ‖ stage 0's pose]; stage i > 0 [stage
    i-1's image ‖ stage i-1's pose ‖ stage i's pose], with fits i and masks
    i. Keyword arguments are the ``DeformableGenerator``'s.
    """

    def __init__(self, pose_dim: int, image_size: tuple[int, int],
                 nfilters_enc: Sequence[int], nfilters_dec: Sequence[int],
                 num_stacks: int = 4, **kwargs):
        super().__init__()
        self.num_stacks = num_stacks
        self.generator = DeformableGenerator(pose_dim, image_size,
                                             nfilters_enc, nfilters_dec,
                                             **kwargs)

    def forward(self, inp, target_pose, target_warps, target_masks):
        gen = self.generator
        k = gen.pose_dim
        img, pose, _ = pose_ops.get_imgpose(inp, gen.use_input_pose, k)
        outputs = []
        for i in range(self.num_stacks):
            stage_tg = target_pose[..., i * k:(i + 1) * k]
            parts = [img]
            if gen.use_input_pose:
                parts.append(pose)
            parts.append(stage_tg)
            # a stage's slices are strided; the fold takes its full-size
            # masks as they come (resize_bilinear returns them unchanged)
            masks = None if target_masks is None \
                else target_masks[:, i].contiguous()
            img = gen(torch.cat([p.to(gen.dtype) for p in parts], dim=-1),
                      target_warps[:, i].contiguous(), masks)
            pose = stage_tg
            outputs.append(img)
        return outputs


class Discriminator(nn.Module):
    """Patch discriminator → (N, patches) probabilities.

    k4s2 VALID conv (with bias), then down Blocks of 128, 256, 512 and 1
    filters (no norm on the last; ``check_mode``: 128, 256 and 1). NHWC in,
    computed in ``dtype``; the sigmoid runs in f32 (a bf16 sigmoid
    saturates to exactly 0 or 1 and degenerates the log losses).
    """

    def __init__(self, in_ch: int, check_mode: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        widths = (128, 256) if check_mode else (128, 256, 512)
        layers = [Conv2d(in_ch, 64, 4, 2, 0, device=device)]
        prev = 64
        for wdt in widths:
            layers.append(Block(prev, wdt, device=device))
            prev = wdt
        layers.append(Block(prev, 1, bn=False, device=device))
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        x = self.net(x.to(self.dtype).permute(0, 3, 1, 2))
        return torch.sigmoid(x.float()).reshape(x.shape[0], -1)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Glorot-uniform conv weights, zero biases, unit/zero norm affines
    (the reference's xavier init), drawn from ``generator`` in module
    order."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, VolumeInstanceNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def gaussian_weights_init(module: nn.Module,
                          generator: torch.Generator) -> None:
    """Redraw every convolution and transposed-convolution weight from
    N(0, 0.02) (``weight_init='gaussian'``), in module order from
    ``generator``; biases and the norms' affines stay as they are."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
