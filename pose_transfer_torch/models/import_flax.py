"""Carry the JAX package's weights and optimizer state into the port, and
the port's weights back into the JAX layout.

``generator_state_dict_from_flax`` and ``discriminator_state_dict_from_flax``
take the params of ``pose_transfer_tpu.models.DeformableGenerator``,
``StackedGenerator`` (the same keys under ``generator.``, the reference's
prefix), ``UNetGenerator`` (``encoder.*``, ``decoder.*``) or
``Discriminator`` (full width or check mode) as nested dicts of numpy
arrays (``{"params": {...}}`` or the inner dict) and return the port's
state_dicts, under the reference PyTorch names; ``vgg_state_dict_from_flax``
does the same for the JAX package's VGG19 features. They are the inverse of
``pose_transfer_tpu/models/import_torch.py``:
  conv kernel HWIO → OIHW
  transposed-conv kernel: undo the spatial flip, then
    (kh, kw, in, out) → (in, out, kh, kw)
  scalar norm scale/bias → shape (1,)

``adam_state_dict_from_flax`` maps the JAX package's optax Adam state
(``(ScaleByAdamState(count, mu, nu), EmptyState())``, as
``flax.serialization.msgpack_restore`` gives it: ``{'0': {'count', 'mu',
'nu'}, '1': {}}``) to a ``torch.optim.Adam`` state_dict: ``mu`` →
``exp_avg``, ``nu`` → ``exp_avg_sq``, each moved like its parameter,
``count`` → ``step``.

``generator_params_to_flax`` and ``discriminator_params_to_flax`` are the
other direction, the port's counterpart of
``pose_transfer_tpu/models/import_torch.py``: a port (or reference)
state_dict → the flax params tree ``{"params": {...}}``, keys sorted as
JAX's tree utilities sort them. ``train_state_to_flax`` builds the two
trees the JAX package's ``checkpoint.save`` writes.
"""

from __future__ import annotations

import numpy as np
import torch

from .networks import Discriminator


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
    """Flax DeformableGenerator, StackedGenerator or UNetGenerator params →
    the port's generator state_dict (the module is told by its trees)."""
    p = params.get("params", params)
    sd: dict = {}
    if "encoder" in p:                                  # U-Net
        _encoder(p["encoder"], "encoder", sd)
        _decoder(p["decoder"], "decoder", sd)
        return sd
    prefix = ""
    if "generator" in p:                                # stacked
        p, prefix = p["generator"], "generator."
    _encoder(p["encoder_app"], prefix + "encoder_app", sd)
    _encoder(p["encoder_pose"], prefix + "encoder_pose", sd)
    _decoder(p["decoder"], prefix + "decoder", sd)
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


def state_dict_from_flax(module: torch.nn.Module, params: dict) -> dict:
    """``params`` mapped for ``module``: the discriminator's mapping for a
    ``Discriminator``, the generators' otherwise."""
    if isinstance(module, Discriminator):
        return discriminator_state_dict_from_flax(params)
    return generator_state_dict_from_flax(params)


def adam_state_dict_from_flax(opt_state: dict, module: torch.nn.Module,
                              optimizer: torch.optim.Optimizer) -> dict:
    """The JAX package's optax Adam state of ``module``'s params → a
    state_dict for ``optimizer`` (a ``torch.optim.Adam`` over
    ``module.parameters()``, in that order), its param groups kept."""
    adam = opt_state["0"]
    if set(adam) != {"count", "mu", "nu"} or opt_state.get("1", {}) != {}:
        raise ValueError("not an optax Adam state (expected "
                         "{'0': {'count', 'mu', 'nu'}, '1': {}}), got keys "
                         f"{sorted(opt_state)}")
    mu = state_dict_from_flax(module, adam["mu"])
    nu = state_dict_from_flax(module, adam["nu"])
    names = [n for n, _ in module.named_parameters()]
    if set(mu) != set(names):
        raise ValueError(f"optimizer state and module differ: "
                         f"{sorted(set(mu) ^ set(names))[:4]}")
    step = float(np.asarray(adam["count"]))
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": torch.tensor(step),
                       "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                   for i, n in enumerate(names)}
    return sd


# ------------------------------------------------ port → the JAX layout

def _np(v) -> np.ndarray:
    return v.detach().cpu().float().numpy() \
        if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _to_conv(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 1, 0)))


def _to_conv_transpose(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 0, 1))[::-1,
                                                                    ::-1])


def _to_scalar(w) -> np.ndarray:
    return _np(w).reshape(())


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _encoder_to_flax(sd: dict, prefix: str) -> dict:
    out = {"Conv_0": {"kernel": _to_conv(sd[f"{prefix}.net.0.weight"]),
                      "bias": _np(sd[f"{prefix}.net.0.bias"])}}
    i = 1
    while f"{prefix}.net.{i}.net.1.weight" in sd:
        block = {"Conv_0": {"kernel": _to_conv(
            sd[f"{prefix}.net.{i}.net.1.weight"])}}
        if f"{prefix}.net.{i}.net.2.weight" in sd:
            block["VolumeInstanceNorm_0"] = {
                "scale": _to_scalar(sd[f"{prefix}.net.{i}.net.2.weight"]),
                "bias": _to_scalar(sd[f"{prefix}.net.{i}.net.2.bias"])}
        out[f"Block_{i - 1}"] = block
        i += 1
    return out


def _decoder_to_flax(sd: dict, prefix: str) -> dict:
    out = {}
    i = 0
    while f"{prefix}.net.{i}.net.1.weight" in sd:
        block = {"ConvTranspose_0": {"kernel": _to_conv_transpose(
            sd[f"{prefix}.net.{i}.net.1.weight"])}}
        if f"{prefix}.net.{i}.net.3.weight" in sd:
            block["VolumeInstanceNorm_0"] = {
                "scale": _to_scalar(sd[f"{prefix}.net.{i}.net.3.weight"]),
                "bias": _to_scalar(sd[f"{prefix}.net.{i}.net.3.bias"])}
        out[f"Block_{i}"] = block
        i += 1
    # net[i] is the final ReLU, net[i + 1] the final conv
    out["Conv_0"] = {"kernel": _to_conv(sd[f"{prefix}.net.{i + 1}.weight"]),
                     "bias": _np(sd[f"{prefix}.net.{i + 1}.bias"])}
    return out


def generator_params_to_flax(sd: dict) -> dict:
    """A deformable, stacked (``generator.*``) or U-Net (``encoder.*``)
    generator state_dict → the flax params ``{"params": {...}}``."""
    if any(k.startswith("encoder.") for k in sd):             # U-Net
        p = {"encoder": _encoder_to_flax(sd, "encoder"),
             "decoder": _decoder_to_flax(sd, "decoder")}
        return _sorted({"params": p})
    pre = "generator." if any(k.startswith("generator.") for k in sd) \
        else ""
    p = {"encoder_app": _encoder_to_flax(sd, pre + "encoder_app"),
         "encoder_pose": _encoder_to_flax(sd, pre + "encoder_pose"),
         "decoder": _decoder_to_flax(sd, pre + "decoder")}
    if pre:
        p = {"generator": p}
    return _sorted({"params": p})


def discriminator_params_to_flax(sd: dict) -> dict:
    """A discriminator state_dict (full width or check mode) → the flax
    params ``{"params": {...}}``."""
    p = {"Conv_0": {"kernel": _to_conv(sd["net.0.weight"]),
                    "bias": _np(sd["net.0.bias"])}}
    i = 1
    while f"net.{i}.net.1.weight" in sd:
        block = {"Conv_0": {"kernel": _to_conv(sd[f"net.{i}.net.1.weight"])}}
        if f"net.{i}.net.2.weight" in sd:
            block["VolumeInstanceNorm_0"] = {
                "scale": _to_scalar(sd[f"net.{i}.net.2.weight"]),
                "bias": _to_scalar(sd[f"net.{i}.net.2.bias"])}
        p[f"Block_{i - 1}"] = block
        i += 1
    return _sorted({"params": p})


def params_to_flax(module: torch.nn.Module, sd: dict | None = None) -> dict:
    """``module``'s state_dict (or ``sd``, a dict of the same names) in
    the flax layout."""
    sd = module.state_dict() if sd is None else sd
    if isinstance(module, Discriminator):
        return discriminator_params_to_flax(sd)
    return generator_params_to_flax(sd)


def adam_state_to_flax(module: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> dict:
    """Inverse of ``adam_state_dict_from_flax``: ``optimizer``'s Adam state
    over ``module.parameters()`` → ``{'0': {'count', 'mu', 'nu'}, '1':
    {}}`` (zero moments for a parameter not yet stepped)."""
    names = [n for n, _ in module.named_parameters()]
    params = [p for _, p in module.named_parameters()]
    mu, nu, count = {}, {}, 0
    for n, p in zip(names, params):
        st = optimizer.state.get(p, {})
        mu[n] = st.get("exp_avg", torch.zeros_like(p))
        nu[n] = st.get("exp_avg_sq", torch.zeros_like(p))
        if "step" in st:
            count = int(st["step"])
    return {"0": {"count": np.asarray(count, np.int32),
                  "mu": params_to_flax(module, mu),
                  "nu": params_to_flax(module, nu)},
            "1": {}}


def train_state_to_flax(state, seed: int = 0) -> tuple[dict, dict]:
    """The trees ``pose_transfer_tpu.train.checkpoint.save`` writes for a
    ``TrainState``: gen ``{params, opt_state, step, rng}`` and disc
    ``{params, opt_state}``. A torch generator state is no JAX key: ``rng``
    is ``jax.random.PRNGKey(seed)``'s value, the seed's two 32-bit
    halves."""
    gen = {"params": params_to_flax(state.gen),
           "opt_state": adam_state_to_flax(state.gen, state.gen_opt),
           "step": np.asarray(state.step, np.int32),
           "rng": np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)}
    disc = {"params": params_to_flax(state.disc),
            "opt_state": adam_state_to_flax(state.disc, state.disc_opt)}
    return gen, disc
