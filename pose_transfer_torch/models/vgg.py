"""VGG19 features for the evaluation's feature metrics.

Counterpart of ``pose_transfer_tpu/models/vgg.py``. ``VGG19Features`` holds
torchvision's ``features`` stack under its names (``features.{index}.*``),
so a torchvision VGG19 state_dict loads as it is. Kept from the reference,
as the JAX package keeps them:

- ``get_layer_ind`` maps a Keras-style ``blockB_convC`` name to
  ``offset + C - 1`` with offsets (0, 5, 10, 19, 28): the ReLU before conv
  C, not conv C itself;
- ``preprocess_for_vgg(mode='reference')`` reproduces the reference's
  reshape quirk (ImageNet mean/std applied by flat NCHW position mod 3, on
  [-1, 1] inputs); 'correct' rescales to [0, 1] and normalizes per
  channel.

Without a weight file, ``random_vgg19_features(seed)`` draws Glorot-uniform
filters from a ``torch.Generator`` seeded with ``seed`` (the port's own
draw: it is not the JAX package's random stack).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# torchvision VGG19 'features' configuration (cfg 'E'):
# integers are conv output channels, 'M' is 2x2 max-pool.
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def features_layout() -> list[tuple[str, int]]:
    """The torch ``features`` module list: [('conv', out_ch) | ('relu', 0) |
    ('pool', 0)], index-aligned with torchvision VGG19."""
    layout = []
    for v in VGG19_CFG:
        if v == "M":
            layout.append(("pool", 0))
        else:
            layout.append(("conv", v))
            layout.append(("relu", 0))
    return layout


def get_layer_ind(layer_name: str) -> int:
    """Keras ``blockB_convC`` → torch features index, with the reference's
    off-by-one onto the ReLU."""
    block, conv = layer_name.split("_")
    offsets = [0, 5, 10, 19, 28]
    return offsets[int(block[-1]) - 1] + int(conv[-1]) - 1


class VGG19Features(nn.Module):
    """torchvision's VGG19 ``features`` stack (f32 parameters; the two
    constructors below return it frozen, in eval mode)."""

    def __init__(self, device=None):
        super().__init__()
        layers: list[nn.Module] = []
        in_ch = 3
        for kind, out_ch in features_layout():
            if kind == "conv":
                layers.append(nn.Conv2d(in_ch, out_ch, 3, padding=1,
                                        device=device))
                in_ch = out_ch
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)


def random_vgg19_features(seed: int = 0, device="cpu") -> VGG19Features:
    """Glorot-uniform filters and zero biases, drawn in layer order from a
    generator seeded with ``seed``."""
    vgg = VGG19Features(device="meta").to_empty(device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    for m in vgg.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.xavier_uniform_(m.weight, generator=g)
            nn.init.zeros_(m.bias)
    return vgg.eval().requires_grad_(False)


def load_torch_vgg19_features(path: str, device="cpu") -> VGG19Features:
    """A VGG19 from a local torch checkpoint: torchvision's full
    state_dict (``vgg19-dcbb9e9d.pth``), a ``features.*`` dict, or a
    pickled module; only the ``features.*`` entries are read."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    vgg = VGG19Features(device="meta").to_empty(device=device)
    vgg.load_state_dict({k: v for k, v in state.items()
                         if k.startswith("features.")})
    return vgg.eval().requires_grad_(False)


def preprocess_for_vgg(x: torch.Tensor, mode: str = "correct") -> torch.Tensor:
    """ImageNet normalization of [-1, 1] NHWC images.

    mode='correct': [0,1]-rescale then per-channel mean/std.
    mode='reference': the reference's reshape quirk — mean/std indexed by
    NCHW flat position mod 3, input left in [-1, 1].
    """
    mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
    if mode == "correct":
        return ((x + 1.0) * 0.5 - mean) / std
    if mode != "reference":
        raise ValueError(f"unknown preprocess mode {mode!r}")
    n, h, w, c = x.shape
    nchw = x.permute(0, 3, 1, 2).reshape(n, -1)
    idx = torch.arange(nchw.shape[1], device=x.device) % 3
    nchw = (nchw - mean[idx]) / std[idx]
    return nchw.reshape(n, c, h, w).permute(0, 2, 3, 1)


def extract_features(vgg: VGG19Features, x: torch.Tensor, layer_index: int,
                     preprocess_mode: str = "correct") -> torch.Tensor:
    """``features[0..layer_index]`` on NHWC [-1, 1] images → NHWC, in
    ``x``'s dtype."""
    y = preprocess_for_vgg(x, preprocess_mode).permute(0, 3, 1, 2)
    for layer in vgg.features[:layer_index + 1]:
        if isinstance(layer, nn.Conv2d):
            y = F.conv2d(y, layer.weight.to(y.dtype), layer.bias.to(y.dtype),
                         padding=1)
        else:
            y = layer(y)
    return y.permute(0, 2, 3, 1)


def extract_named(vgg: VGG19Features, x: torch.Tensor, layer_name: str,
                  preprocess_mode: str = "correct") -> torch.Tensor:
    """``extract_features`` addressed by the Keras layer name."""
    return extract_features(vgg, x, get_layer_ind(layer_name),
                            preprocess_mode)
