"""Generator construction and the inference step.

Counterpart of ``GANConfig``, ``build_models`` and ``make_eval_step`` in
``pose_transfer_tpu/train/engine.py``, for serving: only the baseline
deformable generator, and only the fields serving reads. The step runs
eagerly under ``torch.inference_mode()``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.device import make_batch_preparer
from ..models.networks import (
    DeformableGenerator,
    decoder_filters_for,
    encoder_filters_for,
    init_weights,
)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``, which must
    exist (there is no silent fall back to the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """Serving configuration of the baseline deformable generator."""
    image_size: tuple[int, int] = (256, 256)
    pose_dim: int = 18
    batch_size: int = 4
    use_input_pose: bool = True
    warp_skip: str = "mask"        # 'mask' | 'full' | 'none'
    warp_agg: str = "max"          # 'max' | 'avg'
    # kernel-placed windowed fold: None = auto (on for CUDA and 'max')
    warp_windowed: bool | None = None
    compute_dtype: torch.dtype = torch.float32

    @property
    def input_nc(self) -> int:
        """Packed input channels."""
        k = self.pose_dim
        return 3 + 2 * k if self.use_input_pose else 3 + k

    @property
    def num_warp_transforms(self) -> int:
        return 10 if self.warp_skip == "mask" else 1


def build_models(config: GANConfig, seed: int = 0,
                 device=None) -> DeformableGenerator:
    """The generator for ``config``, Glorot-initialised from ``seed``, in
    eval mode on ``device`` (default ``cuda``).

    Windowing follows the JAX package's auto rule: the kernel-placed
    windowed fold is on when the placement kernel runs (a CUDA device) and
    the fold is a max.
    """
    device = resolve_device(device)
    windowed = config.warp_windowed
    if windowed is None:
        windowed = device.type == "cuda" and config.warp_agg == "max"
    gen = DeformableGenerator(
        pose_dim=config.pose_dim, image_size=config.image_size,
        nfilters_enc=encoder_filters_for(config.image_size),
        nfilters_dec=decoder_filters_for(config.image_size),
        warp_skip=config.warp_skip, warp_agg=config.warp_agg,
        use_input_pose=config.use_input_pose, warp_windowed=windowed,
        dtype=config.compute_dtype, device="meta")
    gen = gen.to_empty(device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    init_weights(gen, g)
    return gen.eval()


def make_eval_step(config: GANConfig, gen: DeformableGenerator, device=None):
    """Inference forward on a compact batch → (images, prepared batch).

    Moves ``gen`` to ``device`` (default ``cuda``) in eval mode; the step
    takes a compact numpy batch and returns (N, H, W, 3) images in [-1, 1]
    on the device.
    """
    device = resolve_device(device)
    gen.to(device).eval()
    prepare = make_batch_preparer(
        image_size=config.image_size, pose_dim=config.pose_dim,
        device=device, use_input_pose=config.use_input_pose,
        warp_skip=config.warp_skip, dtype=config.compute_dtype)

    def eval_step(batch_raw: dict):
        with torch.inference_mode():
            batch = prepare(batch_raw)
            out = gen(batch["input"], batch["warps"], batch["masks"])
        return out, batch

    return eval_step
