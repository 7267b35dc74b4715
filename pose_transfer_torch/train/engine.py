"""Model construction, the inference step and the two-phase GAN train step.

Counterpart of ``GANConfig``, ``build_models``, ``disc_input``,
``create_state``, ``make_optimizer``, ``make_train_step`` and
``make_eval_step`` in ``pose_transfer_tpu/train/engine.py``, for the
baseline deformable generator with L1 reconstruction. Steps run eagerly:
inference under ``torch.inference_mode()``; training as the JAX package's
cadence — ``training_ratio`` discriminator updates (each on a fake-path
draw and an independent real draw, the generator forward under
``torch.no_grad()``), then one generator update, both with Adam.

Each step sets the module modes it needs (eval for inference, train for
training), so a server and a trainer may share one generator in turn.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.device import make_batch_preparer
from ..models.networks import (
    ChannelDropout,
    DeformableGenerator,
    Discriminator,
    decoder_filters_for,
    encoder_filters_for,
    init_weights,
)
from . import losses


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
    """Configuration of the baseline deformable generator: serving and the
    L1 training recipe."""
    image_size: tuple[int, int] = (256, 256)
    pose_dim: int = 18
    batch_size: int = 4
    use_input_pose: bool = True
    warp_skip: str = "mask"        # 'mask' | 'full' | 'none'
    warp_agg: str = "max"          # 'max' | 'avg'
    # windowed fold: None = auto (``auto_windowed``); it applies to the
    # stages that the 'pallas' backend leaves to 'matmul'
    warp_windowed: bool | None = None
    # windowed placement: 'auto' | 'kernel' (the fold_place kernel where the
    # shape qualifies) | 'xla' (gather/compare/scatter per part window)
    warp_place: str = "auto"
    # 'matmul' (two-pass banded products) | 'pallas' (the fused two-pass
    # warp fold, ops/warp_pallas.py); 'exact' is not ported and raises
    warp_backend: str = "matmul"
    compute_dtype: torch.dtype = torch.float32
    training_ratio: int = 1        # discriminator updates per generator one
    learning_rate: float = 2e-4
    l1_penalty_weight: float = 100.0
    gan_penalty_weight: float = 1.0
    tv_penalty_weight: float = 0.0
    # only 'none' (L1) is ported; VGG content losses and nn_loss are not
    content_loss_layer: str = "none"

    @property
    def input_nc(self) -> int:
        """Packed input channels."""
        k = self.pose_dim
        return 3 + 2 * k if self.use_input_pose else 3 + k

    @property
    def num_warp_transforms(self) -> int:
        return 10 if self.warp_skip == "mask" else 1


def auto_windowed(config: GANConfig, device: torch.device) -> bool:
    """``config.warp_windowed``, or where it is None the JAX package's auto
    rule (``engine.py:153-157``, its TPU read as a CUDA device): windowed
    when the placement kernel places (a CUDA device, a max fold, placement
    not 'xla'), or at a batch of 16 or more, where the gather/scatter
    placement pays for itself."""
    if config.warp_windowed is not None:
        return config.warp_windowed
    kernel_place = (config.warp_place != "xla" and config.warp_agg == "max"
                    and device.type == "cuda")
    return kernel_place or config.batch_size >= 16


def build_models(config: GANConfig, seed: int = 0,
                 device=None) -> DeformableGenerator:
    """The generator for ``config``, Glorot-initialised from ``seed``, in
    eval mode on ``device`` (default ``cuda``); windowing by
    ``auto_windowed``. ``warp_backend='exact'`` raises NotImplementedError.
    """
    device = resolve_device(device)
    windowed = auto_windowed(config, device)
    gen = DeformableGenerator(
        pose_dim=config.pose_dim, image_size=config.image_size,
        nfilters_enc=encoder_filters_for(config.image_size),
        nfilters_dec=decoder_filters_for(config.image_size),
        warp_skip=config.warp_skip, warp_agg=config.warp_agg,
        use_input_pose=config.use_input_pose, warp_windowed=windowed,
        warp_backend=config.warp_backend, warp_place=config.warp_place,
        dtype=config.compute_dtype, device="meta")
    gen = gen.to_empty(device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    init_weights(gen, g)
    return gen.eval()


def make_eval_step(config: GANConfig, gen: DeformableGenerator, device=None):
    """Inference forward on a compact batch → (images, prepared batch).

    Moves ``gen`` to ``device`` (default ``cuda``); the step puts it in
    eval mode, takes a compact numpy batch and returns (N, H, W, 3) images
    in [-1, 1] on the device.
    """
    device = resolve_device(device)
    gen.to(device)
    prepare = make_batch_preparer(
        image_size=config.image_size, pose_dim=config.pose_dim,
        device=device, use_input_pose=config.use_input_pose,
        warp_skip=config.warp_skip, dtype=config.compute_dtype)

    def eval_step(batch_raw: dict):
        gen.eval()
        with torch.inference_mode():
            batch = prepare(batch_raw)
            out = gen(batch["input"], batch["warps"], batch["masks"])
        return out, batch

    return eval_step


# ----------------------------------------------------------------- training

def _check_train_config(config: GANConfig) -> None:
    if config.content_loss_layer != "none":
        raise NotImplementedError(
            f"content_loss_layer={config.content_loss_layer!r}: the VGG "
            "content loss and nn_loss are not ported yet (ROADMAP.md §A); "
            "only L1 reconstruction ('none') trains")
    if config.training_ratio < 1:
        raise ValueError("training_ratio must be >= 1")


def make_optimizer(config: GANConfig, params) -> torch.optim.Adam:
    """Adam, lr ``config.learning_rate`` (2e-4), betas (0.5, 0.999),
    eps 1e-8 — the reference's."""
    return torch.optim.Adam(params, lr=config.learning_rate,
                            betas=(0.5, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """Everything a training run mutates."""
    gen: DeformableGenerator
    disc: Discriminator
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer
    rng: torch.Generator           # channel-dropout draws
    step: int = 0


def create_state(config: GANConfig, seed: int = 0,
                 device=None) -> TrainState:
    """Glorot-initialised generator and discriminator, both optimizers,
    step 0 and the dropout generator, on ``device`` (default ``cuda``). The
    three seeds derive from ``seed`` (one numpy ``SeedSequence``)."""
    _check_train_config(config)
    device = resolve_device(device)
    gen_seed, disc_seed, rng_seed = (
        int(s.generate_state(1)[0])
        for s in np.random.SeedSequence(seed).spawn(3))
    gen = build_models(config, gen_seed, device)
    # the discriminator's input: the packed input with the candidate image
    disc = Discriminator(config.input_nc + 3, dtype=config.compute_dtype,
                         device="meta").to_empty(device=device)
    g = torch.Generator(device=device)
    g.manual_seed(disc_seed)
    init_weights(disc, g)
    rng = torch.Generator(device=device)
    rng.manual_seed(rng_seed)
    return TrainState(gen=gen, disc=disc,
                      gen_opt=make_optimizer(config, gen.parameters()),
                      disc_opt=make_optimizer(config, disc.parameters()),
                      rng=rng)


def disc_input(inp_packed: torch.Tensor, candidate: torch.Tensor,
               config: GANConfig) -> torch.Tensor:
    """[src img ‖ (src pose) ‖ candidate ‖ target pose]: the candidate image
    spliced in before the packed input's target pose."""
    split = 3 + config.pose_dim if config.use_input_pose else 3
    return torch.cat([inp_packed[..., :split],
                      candidate.to(inp_packed.dtype),
                      inp_packed[..., split:]], dim=-1)


class TrainStep:
    """One training iteration: ``step(disc_fake, disc_real, gen_batch) →
    (metrics, out_gen)``.

    ``disc_fake`` and ``disc_real`` are compact batches with a leading
    ``training_ratio`` axis (two independent draws per discriminator
    update); ``gen_batch`` is one compact batch. Metrics stay on the
    device: ``{'gen': [total, ll, ad], 'disc': [total, true, fake]}``, the
    disc row averaged over the draws. ``out_gen`` is the generator phase's
    (N, H, W, 3) output. The two phases are methods, so that a profiler
    can time them.
    """

    def __init__(self, config: GANConfig, state: TrainState):
        _check_train_config(config)
        self.config = config
        self.state = state
        device = next(state.gen.parameters()).device
        self.prepare = make_batch_preparer(
            image_size=config.image_size, pose_dim=config.pose_dim,
            device=device, use_input_pose=config.use_input_pose,
            warp_skip=config.warp_skip, dtype=config.compute_dtype)
        for m in state.gen.modules():
            if isinstance(m, ChannelDropout):
                m.generator = state.rng

    def _prepare(self, raw: dict) -> dict:
        with torch.no_grad():
            batch = self.prepare(raw)
        if batch["input"].shape[0] != self.config.batch_size:
            raise ValueError(f"batch of {batch['input'].shape[0]} rows, "
                             f"config.batch_size is {self.config.batch_size}")
        return batch

    def disc_phase(self, fake_raw: dict, real_raw: dict) -> torch.Tensor:
        """One discriminator update → [total, true, fake]."""
        cfg, st = self.config, self.state
        n = cfg.batch_size
        fake, real = self._prepare(fake_raw), self._prepare(real_raw)
        with torch.no_grad():
            out_gen = st.gen(fake["input"], fake["warps"], fake["masks"])
        both = torch.cat([disc_input(real["input"], real["target"], cfg),
                          disc_input(fake["input"], out_gen, cfg)])
        res = st.disc(both)
        true_loss, fake_loss = losses.disc_adversarial_loss(
            res[:n], res[n:], cfg.gan_penalty_weight, n)
        total = true_loss + fake_loss
        st.disc_opt.zero_grad(set_to_none=True)
        total.backward()
        st.disc_opt.step()
        return torch.stack([total, true_loss, fake_loss]).detach()

    def gen_phase(self, gen_raw: dict):
        """One generator update → ([total, ll, ad], out_gen). Only the
        generator's parameters receive gradients."""
        cfg, st = self.config, self.state
        batch = self._prepare(gen_raw)
        out_gen = st.gen(batch["input"], batch["warps"], batch["masks"])
        d_out = st.disc(disc_input(batch["input"], out_gen, cfg))
        ad = losses.gen_adversarial_loss(d_out, cfg.gan_penalty_weight,
                                         cfg.batch_size)
        ll = losses.l1_loss(out_gen, batch["target"]) * cfg.l1_penalty_weight
        total = ad + ll
        if cfg.tv_penalty_weight:
            total = total + cfg.tv_penalty_weight * \
                losses.total_variation_loss(out_gen)
        st.gen_opt.zero_grad(set_to_none=True)
        total.backward(inputs=list(st.gen.parameters()))
        st.gen_opt.step()
        return torch.stack([total, ll, ad]).detach(), out_gen.detach()

    def __call__(self, disc_fake: dict, disc_real: dict, gen_batch: dict):
        cfg, st = self.config, self.state
        st.gen.train()
        st.disc.train()
        draws = []
        for i in range(cfg.training_ratio):
            fake = {k: v[i] for k, v in disc_fake.items()}
            real = {k: v[i] for k, v in disc_real.items()}
            draws.append(self.disc_phase(fake, real))
        gen_metrics, out_gen = self.gen_phase(gen_batch)
        st.step += 1
        return {"gen": gen_metrics,
                "disc": torch.stack(draws).mean(dim=0)}, out_gen


def make_train_step(config: GANConfig, state: TrainState) -> TrainStep:
    """The two-phase train step on ``state`` (see ``TrainStep``)."""
    return TrainStep(config, state)
