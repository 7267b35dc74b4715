"""Import the original pose-gan Keras weights into the port.

Counterpart of ``pose_transfer_tpu/models/import_keras.py``. The reference
bootstraps its torch models from the Keras weights with
``keras_to_pytorch``: it walks the torch module tree in registration order
(encoder_app → encoder_pose → decoder; convs then norms inside each
Block), consuming a flat list of Keras layers in order, skipping the
layers without weights (activations, dropout, cropping), and maps

  Keras Conv2D/Conv2DTranspose kernel (kh, kw, ·, ·) → torch by
  ``np.transpose(w, [3, 2, 0, 1])``; a bias as it is;
  InstanceNormalization (scale, bias) as they are.

The port's modules carry the reference's names, so the walk writes the
port's state_dict directly (the JAX package goes on to flax params). The
check-mode discriminator follows the port's own 3-block layout (128, 256
and 1 filters), where the JAX walk reads 2 blocks.

No Keras runtime is needed: ``layers`` is any sequence of per-layer weight
lists (what ``layer.get_weights()`` returns: an empty list for a layer
without weights), and ``load_keras_h5`` reads that sequence from a Keras
``.h5`` weights file with ``h5py``, imported when called.
"""

from __future__ import annotations

import numpy as np
import torch


def load_keras_h5(path: str) -> list[list[np.ndarray]]:
    """Keras ``save_weights`` .h5 → per-layer weight lists, in layer order.

    Reads the bare layout (the file's root holds the layer groups) and the
    ``model_weights`` group of a full ``model.save`` file.
    """
    import h5py

    out: list[list[np.ndarray]] = []
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        layer_names = [n.decode() if isinstance(n, bytes) else n
                       for n in g.attrs["layer_names"]]
        for ln in layer_names:
            lg = g[ln]
            weight_names = [n.decode() if isinstance(n, bytes) else n
                            for n in lg.attrs.get("weight_names", [])]
            out.append([np.asarray(lg[wn]) for wn in weight_names])
    return out


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


class _Walk:
    """Sequential consumer of the Keras layers with weights (the others are
    skipped, as the reference's ``len(weights) == 0`` branch does)."""

    def __init__(self, layers):
        self._it = iter([list(ws) for ws in layers if len(ws)])

    def conv(self, key: str, sd: dict, bias: bool) -> None:
        ws = self._next(key)
        if ws[0].ndim != 4:
            raise ValueError(
                f"{key}: expected a 4-D conv kernel, got shape "
                f"{ws[0].shape} (Keras layer order mismatch)")
        sd[key + ".weight"] = _t(np.transpose(ws[0], (3, 2, 0, 1)))
        if bias:
            if len(ws) != 2:
                raise ValueError(f"{key}: expected kernel+bias, got "
                                 f"{len(ws)} weights")
            sd[key + ".bias"] = _t(ws[1])
        elif len(ws) != 1:
            raise ValueError(
                f"{key}: the reference conv here has no bias but the Keras "
                f"layer has {len(ws)} weights")

    def norm(self, key: str, sd: dict) -> None:
        ws = self._next(key)
        if len(ws) != 2 or ws[0].ndim != 1:
            raise ValueError(
                f"{key}: expected InstanceNormalization (scale, bias), "
                f"got {[w.shape for w in ws]}")
        sd[key + ".weight"] = _t(ws[0])
        sd[key + ".bias"] = _t(ws[1])

    def _next(self, key: str) -> list[np.ndarray]:
        try:
            return next(self._it)
        except StopIteration:
            raise ValueError(f"ran out of Keras layers at {key}") from None


def _encoder_sd(walk: _Walk, prefix: str, n_stages: int, sd: dict) -> None:
    """The reference encoder's order: the stage-0 conv (with bias), then
    Blocks — conv (no bias) + InstanceNorm but on the last stage."""
    walk.conv(f"{prefix}.net.0", sd, bias=True)
    for i in range(1, n_stages):
        walk.conv(f"{prefix}.net.{i}.net.1", sd, bias=False)
        if i != n_stages - 1:
            walk.norm(f"{prefix}.net.{i}.net.2", sd)


def _decoder_sd(walk: _Walk, prefix: str, n_stages: int, sd: dict) -> None:
    """The reference decoder's order: Blocks — ConvTranspose (no bias) +
    InstanceNorm — then the final k3 conv (net[n] after the ReLU)."""
    for i in range(n_stages - 1):
        walk.conv(f"{prefix}.net.{i}.net.1", sd, bias=False)
        walk.norm(f"{prefix}.net.{i}.net.3", sd)
    walk.conv(f"{prefix}.net.{n_stages}", sd, bias=True)


def import_generator_keras(layers, n_enc: int, n_dec: int,
                           stacked: bool = False) -> dict:
    """Keras pose-gan generator weights → the port's generator state_dict
    (``DeformableGenerator``, or with ``stacked`` the ``StackedGenerator``'s
    ``generator.*`` names).

    Args:
      layers: per-layer weight lists in model order (``load_keras_h5``, or
        ``[l.get_weights() for l in model.layers]``).
      n_enc/n_dec: stage counts, ``len(encoder_filters_for(image_size))``.
    """
    walk = _Walk(layers)
    sd: dict = {}
    _encoder_sd(walk, "encoder_app", n_enc, sd)
    _encoder_sd(walk, "encoder_pose", n_enc, sd)
    _decoder_sd(walk, "decoder", n_dec, sd)
    if stacked:
        sd = {"generator." + k: v for k, v in sd.items()}
    return sd


def import_discriminator_keras(layers, check_mode: bool = False) -> dict:
    """Keras pose-gan discriminator weights → the port's discriminator
    state_dict: the first conv, then 4 Blocks (check mode: 3), the last
    without a norm."""
    walk = _Walk(layers)
    sd: dict = {}
    n_blocks = 3 if check_mode else 4
    walk.conv("net.0", sd, bias=True)
    for i in range(1, n_blocks + 1):
        walk.conv(f"net.{i}.net.1", sd, bias=False)
        if i != n_blocks:
            walk.norm(f"net.{i}.net.2", sd)
    return sd
