"""The content loss of the paper's Full model (the reference code's
``full_fasion``: ``--content_loss_layer block1_conv2 --nn_loss_area_size
5``), in float32, in plain PyTorch: a VGG19 prefix over both images and
the nearest-neighbour distance between their features.

- The VGG19 is torchvision's ``features`` stack (``features.{index}.*``),
  run up to the layer that the reference code's ``get_layer_ind`` names:
  ``blockB_convC`` → offsets (0, 5, 10, 19, 28)[B − 1] + C − 1, one short
  of conv C, so ``block1_conv2`` is the ReLU after conv1_1.
- Its input: [−1, 1] NHWC images rescaled to [0, 1], then the ImageNet
  mean and std per channel (the 'correct' preprocessing).
- ``nn_loss``: the target's features padded with −10000 (``area // 2``
  on both axes), then the mean over (n, y, x) of the least, over the
  area² shifts (i, j), of Σ_c |G_pad[n, y + i, x + j, c] − P[n, y, x, c]|;
  P the generated image's features, G the target's, which takes no
  gradient.

Departure from the program: the gradient flows by autograd through the
chain of ``torch.minimum``s, which splits it between shifts that tie
exactly; the program hands a tie to the first shift. Where the tied
shifts read the same target features (a flat region of the target), the
two agree.

``q`` is applied to both operands of every convolution, as in
``model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .model import ident

# torchvision VGG19 'features' (configuration 'E'): conv widths, 'M' a
# 2 × 2 max-pool; every conv is followed by a ReLU
VGG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
BLOCK_OFFSETS = (0, 5, 10, 19, 28)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PAD_VALUE = -10000.0
# bytes of autograd residuals one block of rows may keep through the
# chain of minimums (each shift keeps its difference tensor)
BLOCK_BYTES = 4 << 30


def layout() -> list[tuple[str, int, int]]:
    """The ``features`` modules in order: ('conv', in, out), ('relu', 0,
    0) or ('pool', 0, 0)."""
    out, in_ch = [], 3
    for v in VGG19:
        if v == "M":
            out.append(("pool", 0, 0))
        else:
            out += [("conv", in_ch, v), ("relu", 0, 0)]
            in_ch = v
    return out


def layer_index(name: str) -> int:
    """``blockB_convC`` → the index of the last ``features`` module run."""
    block, conv = name.split("_")
    if not (block.startswith("block") and conv.startswith("conv")):
        raise ValueError(f"content layer {name!r} is not blockB_convC")
    return BLOCK_OFFSETS[int(block[5:]) - 1] + int(conv[4:]) - 1


def vgg_spec() -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter of the ``features`` stack, in
    module order, as ``weights.make_weights`` takes them."""
    spec = []
    for i, (kind, in_ch, out_ch) in enumerate(layout()):
        if kind == "conv":
            spec += [(f"features.{i}.weight", (out_ch, in_ch, 3, 3), "conv"),
                     (f"features.{i}.bias", (out_ch,), "bias")]
    return spec


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) images in [−1, 1] → (N, 3, H, W) float32, ImageNet
    normalised."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return ((x.float().permute(0, 3, 1, 2) + 1.0) * 0.5 - mean) / std


def features(p: dict, x: torch.Tensor, index: int, q=ident) -> torch.Tensor:
    """``features[0..index]`` on (N, H, W, 3) images in [−1, 1] → (N, h,
    w, C) float32."""
    y = preprocess(x)
    for i, (kind, _, _) in enumerate(layout()[:index + 1]):
        if kind == "conv":
            y = F.conv2d(q(y), q(p[f"features.{i}.weight"]),
                         p[f"features.{i}.bias"], padding=1)
        elif kind == "relu":
            y = F.relu(y)
        else:
            y = F.max_pool2d(y, 2)
    return y.permute(0, 2, 3, 1)


def _min_distance(pred: torch.Tensor, target: torch.Tensor,
                  area: int) -> torch.Tensor:
    """(n, H, W) least channel-summed L1 distance over the area² shifts."""
    pad = area // 2
    g = F.pad(target, (0, 0, pad, pad, pad, pad), value=PAD_VALUE)
    h, w = pred.shape[1:3]
    best = None
    for i in range(area):
        for j in range(area):
            d = (g[:, i:i + h, j:j + w] - pred).abs().sum(-1)
            best = d if best is None else torch.minimum(best, d)
    return best


def nn_loss(pred: torch.Tensor, target: torch.Tensor, area: int,
            block_rows: int | None = None) -> torch.Tensor:
    """The mean nearest-neighbour distance of (N, H, W, C) ``pred`` to
    ``target`` (no gradient) in an area × area neighbourhood. Rows go in
    blocks of ``block_rows`` (by default as many as keep ``BLOCK_BYTES``
    of residuals), each recomputed in the backward: the loss is a mean
    over rows, so the blocks add up to it exactly."""
    n, h, w, c = pred.shape
    target = target.detach()
    if block_rows is None:
        block_rows = max(1, BLOCK_BYTES // (area * area * h * w * c * 4))
    total = None
    for s in range(0, n, block_rows):
        e = min(n, s + block_rows)
        part = checkpoint(_min_distance, pred[s:e], target[s:e], area,
                          use_reentrant=False).sum()
        total = part if total is None else total + part
    return total / (n * h * w)


def content_loss(vgg: dict, out: torch.Tensor, target: torch.Tensor,
                 layer: str, area: int, q=ident) -> torch.Tensor:
    """``nn_loss`` between the VGG19 features at ``layer`` of the
    generated images ``out`` and of ``target``."""
    index = layer_index(layer)
    with torch.no_grad():
        f_target = features(vgg, target, index, q)
    return nn_loss(features(vgg, out, index, q), f_target, area)
