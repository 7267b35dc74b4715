"""Carry the JAX package's weights into the port.

``generator_state_dict_from_flax`` and ``discriminator_state_dict_from_flax``
take the params of ``pose_transfer_tpu.models.DeformableGenerator`` /
``Discriminator`` (full width or check mode) as nested dicts of numpy
arrays (``{"params": {...}}`` or the inner dict) and return the port's
state_dicts, under the reference PyTorch names; ``vgg_state_dict_from_flax``
does the same for the JAX package's VGG19 features. They are the inverse of
``pose_transfer_tpu/models/import_torch.py``:
  conv kernel HWIO → OIHW
  transposed-conv kernel: undo the spatial flip, then
    (kh, kw, in, out) → (in, out, kh, kw)
  scalar norm scale/bias → shape (1,)
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _conv_transpose(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1)))


def _scalar(v) -> torch.Tensor:
    return _t(np.asarray(v).reshape(1))


def _encoder(p: dict, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.net.0.weight"] = _conv(p["Conv_0"]["kernel"])
    sd[f"{prefix}.net.0.bias"] = _t(p["Conv_0"]["bias"])
    i = 0
    while f"Block_{i}" in p:
        block = p[f"Block_{i}"]
        sd[f"{prefix}.net.{i + 1}.net.1.weight"] = _conv(
            block["Conv_0"]["kernel"])
        if "VolumeInstanceNorm_0" in block:
            norm = block["VolumeInstanceNorm_0"]
            sd[f"{prefix}.net.{i + 1}.net.2.weight"] = _scalar(norm["scale"])
            sd[f"{prefix}.net.{i + 1}.net.2.bias"] = _scalar(norm["bias"])
        i += 1


def _decoder(p: dict, prefix: str, sd: dict) -> None:
    i = 0
    while f"Block_{i}" in p:
        block = p[f"Block_{i}"]
        sd[f"{prefix}.net.{i}.net.1.weight"] = _conv_transpose(
            block["ConvTranspose_0"]["kernel"])
        if "VolumeInstanceNorm_0" in block:
            norm = block["VolumeInstanceNorm_0"]
            sd[f"{prefix}.net.{i}.net.3.weight"] = _scalar(norm["scale"])
            sd[f"{prefix}.net.{i}.net.3.bias"] = _scalar(norm["bias"])
        i += 1
    # net[i] is the final ReLU, net[i + 1] the final conv
    sd[f"{prefix}.net.{i + 1}.weight"] = _conv(p["Conv_0"]["kernel"])
    sd[f"{prefix}.net.{i + 1}.bias"] = _t(p["Conv_0"]["bias"])


def generator_state_dict_from_flax(params: dict) -> dict:
    """Flax DeformableGenerator params → the port's generator state_dict."""
    p = params.get("params", params)
    sd: dict = {}
    _encoder(p["encoder_app"], "encoder_app", sd)
    _encoder(p["encoder_pose"], "encoder_pose", sd)
    _decoder(p["decoder"], "decoder", sd)
    return sd


def discriminator_state_dict_from_flax(params: dict) -> dict:
    """Flax Discriminator params → the port's discriminator state_dict
    (``net.0`` the first conv, ``net.{i}`` the Blocks)."""
    p = params.get("params", params)
    sd: dict = {"net.0.weight": _conv(p["Conv_0"]["kernel"]),
                "net.0.bias": _t(p["Conv_0"]["bias"])}
    i = 0
    while f"Block_{i}" in p:
        block = p[f"Block_{i}"]
        sd[f"net.{i + 1}.net.1.weight"] = _conv(block["Conv_0"]["kernel"])
        if "VolumeInstanceNorm_0" in block:
            norm = block["VolumeInstanceNorm_0"]
            sd[f"net.{i + 1}.net.2.weight"] = _scalar(norm["scale"])
            sd[f"net.{i + 1}.net.2.bias"] = _scalar(norm["bias"])
        i += 1
    return sd


def vgg_state_dict_from_flax(params: dict) -> dict:
    """The JAX package's VGG19 params (``conv{i}_kernel`` HWIO,
    ``conv{i}_bias``) → a torchvision-layout ``features.{index}.*``
    state_dict for ``models.vgg.VGG19Features``."""
    from .vgg import features_layout

    sd: dict = {}
    conv_i = 0
    for index, (kind, _) in enumerate(features_layout()):
        if kind == "conv":
            sd[f"features.{index}.weight"] = _conv(
                params[f"conv{conv_i}_kernel"])
            sd[f"features.{index}.bias"] = _t(params[f"conv{conv_i}_bias"])
            conv_i += 1
    return sd
