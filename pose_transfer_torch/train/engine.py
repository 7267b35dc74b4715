"""Model construction, the inference step and the two-phase GAN train step.

Counterpart of ``GANConfig``, ``build_models``, ``gen_apply``,
``disc_input``, ``create_state``, ``make_optimizer``,
``reconstruction_loss``, ``make_train_step`` and ``make_eval_step`` in
``pose_transfer_tpu/train/engine.py``: the deformable, stacked and U-Net
generators, with L1 or the VGG content loss (``nn_loss`` over VGG19
features) as the reconstruction term. Steps run eagerly:
inference under ``torch.inference_mode()``; training as the JAX package's
cadence — ``training_ratio`` discriminator updates (each on a fake-path
draw and an independent real draw, the generator forward under
``torch.no_grad()``), then one generator update, both with Adam.

Spans (``utils.spans``, while a profiler records): ``step.prepare``
around the batch preparer of either step; ``train.disc_phase`` and
``train.gen_phase`` (attribute ``step``), each with ``train.backward``
and ``train.optimizer``; with a content loss, ``content.features``
(attribute ``area``) around the VGG19 prefix of the generated image and
of the target, beside ``ops.nn_loss``'s ``content.nn_loss``.

Each step sets the module modes it needs (eval for inference, train for
training), so a server and a trainer may share one generator in turn.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.device import make_batch_preparer
from ..models import vgg as vgg_mod
from ..models.networks import (
    ChannelDropout,
    DeformableGenerator,
    Discriminator,
    StackedGenerator,
    UNetGenerator,
    decoder_filters_for,
    encoder_filters_for,
    gaussian_weights_init,
    init_weights,
)
from ..ops.nn_loss import nn_loss
from ..utils.spans import span
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
    """Configuration of serving and training: the generator type and its
    fold, the compute dtype and the training recipe."""
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
    # warp fold, ops/warp_pallas.py) | 'exact' (gather bilinear,
    # ops.warp.warp_feature_single)
    warp_backend: str = "matmul"
    gen_type: str = "baseline"     # 'baseline' | 'stacked' | 'unet'
    num_stacks: int = 4            # stages of the stacked generator
    compute_dtype: torch.dtype = torch.float32
    training_ratio: int = 1        # discriminator updates per generator one
    learning_rate: float = 2e-4
    l1_penalty_weight: float = 100.0
    gan_penalty_weight: float = 1.0
    tv_penalty_weight: float = 0.0
    # 'none' (L1), or a VGG19 layer ('block1_conv2'): nn_loss over its
    # features in an nn_loss_area_size² neighbourhood
    content_loss_layer: str = "none"
    nn_loss_area_size: int = 1
    weight_init: str = "xavier"    # 'xavier' | 'gaussian' (N(0, 0.02))
    # the tiny overfit-smoke model: the first 2 encoder stages, a decoder
    # of (dec[-2], 3), a discriminator of blocks 128, 256 and 1
    check_mode: bool = False
    # data-parallel width (``parallel.config_for_mesh`` sets it); the auto
    # windowed rule reads the per-device batch batch_size // device_count
    device_count: int = 1

    @property
    def input_nc(self) -> int:
        """Packed input channels."""
        k = self.pose_dim
        return 3 + 2 * k if self.use_input_pose else 3 + k

    @property
    def num_warp_transforms(self) -> int:
        return 10 if self.warp_skip == "mask" else 1

    @property
    def filters(self) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """(encoder, decoder) filter ladders for the image size."""
        enc = encoder_filters_for(self.image_size)
        dec = decoder_filters_for(self.image_size)
        if self.check_mode:
            return enc[:2], (dec[-2], 3)
        return enc, dec

    @classmethod
    def from_opt(cls, opt) -> "GANConfig":
        """Build from a parsed reference-style options object or dict:
        every option named as a field, ``image_size`` as a tuple,
        ``checkMode`` as ``check_mode``, the CLI's ``warp_windowed``
        ('auto' | '0' | '1') as None or a bool and a ``compute_dtype``
        name as the torch dtype."""
        if not isinstance(opt, dict):
            opt = vars(opt)
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in opt.items() if k in fields}
        kwargs["image_size"] = tuple(opt["image_size"])
        kwargs["use_input_pose"] = bool(opt["use_input_pose"])
        if "checkMode" in opt:
            kwargs["check_mode"] = bool(opt["checkMode"])
        ww = kwargs.get("warp_windowed")
        if isinstance(ww, str):
            kwargs["warp_windowed"] = None if ww == "auto" else ww == "1"
        if isinstance(kwargs.get("compute_dtype"), str):
            kwargs["compute_dtype"] = getattr(torch, kwargs["compute_dtype"])
        return cls(**kwargs)


def auto_windowed(config: GANConfig, device: torch.device) -> bool:
    """``config.warp_windowed``, or where it is None the JAX package's auto
    rule (``engine.py:143-158``, its TPU read as a CUDA device): windowed
    when the placement kernel places (a CUDA device, a max fold, placement
    not 'xla'), or at a per-device batch (``batch_size // device_count``:
    each rank or replica folds its own rows) of 16 or more, where the
    gather/scatter placement pays for itself."""
    if config.warp_windowed is not None:
        return config.warp_windowed
    kernel_place = (config.warp_place != "xla" and config.warp_agg == "max"
                    and device.type == "cuda")
    per_device = config.batch_size // max(config.device_count, 1)
    return kernel_place or per_device >= 16


def _init(module: torch.nn.Module, config: GANConfig,
          g: torch.Generator) -> None:
    """Glorot-uniform init, then for ``weight_init='gaussian'`` every conv
    weight redrawn from N(0, 0.02), both from ``g``."""
    if config.weight_init not in ("xavier", "gaussian"):
        raise ValueError(f"invalid weight_init {config.weight_init!r}")
    init_weights(module, g)
    if config.weight_init == "gaussian":
        gaussian_weights_init(module, g)


def build_models(config: GANConfig, seed: int = 0,
                 device=None) -> torch.nn.Module:
    """The generator of ``config.gen_type`` (``check_mode``: the tiny
    ladders), initialised from ``seed`` (``weight_init``), in eval mode on
    ``device`` (default ``cuda``); the deformable fold windowed by
    ``auto_windowed``.
    """
    device = resolve_device(device)
    enc, dec = config.filters
    if config.gen_type == "unet":
        gen = UNetGenerator(config.input_nc, enc, dec,
                            dtype=config.compute_dtype, device="meta")
    elif config.gen_type in ("baseline", "stacked"):
        kwargs = dict(
            warp_skip=config.warp_skip, warp_agg=config.warp_agg,
            use_input_pose=config.use_input_pose,
            warp_windowed=auto_windowed(config, device),
            warp_backend=config.warp_backend, warp_place=config.warp_place,
            dtype=config.compute_dtype, device="meta")
        if config.gen_type == "stacked":
            gen = StackedGenerator(config.pose_dim, config.image_size, enc,
                                   dec, num_stacks=config.num_stacks,
                                   **kwargs)
        else:
            gen = DeformableGenerator(config.pose_dim, config.image_size,
                                      enc, dec, **kwargs)
    else:
        raise ValueError(f"invalid gen_type {config.gen_type!r}")
    gen = gen.to_empty(device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    _init(gen, config, g)
    return gen.eval()


def batch_preparer(config: GANConfig, device):
    """``data.device.make_batch_preparer`` for ``config`` on ``device``."""
    return make_batch_preparer(
        image_size=config.image_size, pose_dim=config.pose_dim,
        device=device, use_input_pose=config.use_input_pose,
        warp_skip=config.warp_skip, gen_type=config.gen_type,
        num_stacks=config.num_stacks, dtype=config.compute_dtype)


def gen_apply(gen: torch.nn.Module, batch: dict, config: GANConfig):
    """The generator on a prepared batch → (output, stage outputs): the
    stacked generator's last stage and its list of stages; otherwise the
    output and an empty list."""
    if config.gen_type == "stacked":
        outputs = gen(batch["input"], batch["interpol_pose"],
                      batch["interpol_warps"], batch["interpol_masks"])
        return outputs[-1], outputs
    if config.gen_type == "unet":
        return gen(batch["input"]), []
    return gen(batch["input"], batch["warps"], batch["masks"]), []


def make_eval_step(config: GANConfig, gen: torch.nn.Module, device=None):
    """Inference forward on a compact batch → (images, prepared batch).

    Moves ``gen`` to ``device`` (default ``cuda``); the step puts it in
    eval mode, takes a compact numpy batch and returns images in [-1, 1] on
    the device: (N, H, W, 3), or for the stacked generator every stage's,
    (S, N, H, W, 3).
    """
    device = resolve_device(device)
    gen.to(device)
    prepare = batch_preparer(config, device)

    def eval_step(batch_raw: dict):
        gen.eval()
        with torch.inference_mode():
            with span("step.prepare"):
                batch = prepare(batch_raw)
            out, stages = gen_apply(gen, batch, config)
            if stages:
                out = torch.stack(stages)
        return out, batch

    return eval_step


# ----------------------------------------------------------------- training

def _check_train_config(config: GANConfig) -> None:
    if config.training_ratio < 1:
        raise ValueError("training_ratio must be >= 1")


def make_optimizer(config: GANConfig, params) -> torch.optim.Adam:
    """Adam, lr ``config.learning_rate`` (2e-4), betas (0.5, 0.999),
    eps 1e-8 — the reference's."""
    return torch.optim.Adam(params, lr=config.learning_rate,
                            betas=(0.5, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """Everything a training run mutates, and the frozen VGG19 of the
    content loss (None for L1; in no optimizer and no checkpoint)."""
    gen: torch.nn.Module
    disc: Discriminator
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer
    rng: torch.Generator           # channel-dropout draws
    step: int = 0
    vgg: vgg_mod.VGG19Features | None = None


def create_state(config: GANConfig, seed: int = 0, device=None,
                 vgg: vgg_mod.VGG19Features | None = None) -> TrainState:
    """Generator and discriminator (``weight_init``), both optimizers,
    step 0 and the dropout generator, on ``device`` (default ``cuda``). The
    three seeds derive from ``seed`` (one numpy ``SeedSequence``). With a
    content loss, ``vgg`` (e.g. ``models.vgg.load_torch_vgg19_features``),
    else the seeded random filters ``random_vgg19_features(0)``."""
    _check_train_config(config)
    device = resolve_device(device)
    gen_seed, disc_seed, rng_seed = (
        int(s.generate_state(1)[0])
        for s in np.random.SeedSequence(seed).spawn(3))
    gen = build_models(config, gen_seed, device)
    # the discriminator's input: the packed input with the candidate image
    disc = Discriminator(config.input_nc + 3, check_mode=config.check_mode,
                         dtype=config.compute_dtype,
                         device="meta").to_empty(device=device)
    g = torch.Generator(device=device)
    g.manual_seed(disc_seed)
    _init(disc, config, g)
    rng = torch.Generator(device=device)
    rng.manual_seed(rng_seed)
    if config.content_loss_layer == "none":
        vgg = None
    elif vgg is None:
        vgg = vgg_mod.random_vgg19_features(0, device)
    else:
        vgg = vgg.to(device)
    return TrainState(gen=gen, disc=disc,
                      gen_opt=make_optimizer(config, gen.parameters()),
                      disc_opt=make_optimizer(config, disc.parameters()),
                      rng=rng, vgg=vgg)


def disc_input(inp_packed: torch.Tensor, candidate: torch.Tensor,
               config: GANConfig) -> torch.Tensor:
    """[src img ‖ (src pose) ‖ candidate ‖ target pose]: the candidate image
    spliced in before the packed input's target pose."""
    split = 3 + config.pose_dim if config.use_input_pose else 3
    return torch.cat([inp_packed[..., :split],
                      candidate.to(inp_packed.dtype),
                      inp_packed[..., split:]], dim=-1)


def reconstruction_loss(out_gen: torch.Tensor, target: torch.Tensor,
                        vgg: vgg_mod.VGG19Features | None,
                        config: GANConfig) -> torch.Tensor:
    """L1, or with a content layer ``nn_loss`` (area
    ``nn_loss_area_size``) between the two images' VGG19 features at that
    layer, computed in float32 as in the JAX package
    (``models.vgg.extract_features``, its 'correct' preprocessing: the JAX
    CLI's ``--vgg_preprocess`` reaches no config)."""
    if config.content_loss_layer == "none":
        return losses.l1_loss(out_gen, target)
    layer = vgg_mod.get_layer_ind(config.content_loss_layer)
    a = config.nn_loss_area_size
    with span("content.features", area=f"{a}x{a}"):
        f_gen = vgg_mod.extract_features(vgg, out_gen, layer)
        f_tgt = vgg_mod.extract_features(vgg, target, layer)
    return nn_loss(f_gen, f_tgt, a, a)


class TrainStep:
    """One training iteration: ``step(disc_fake, disc_real, gen_batch) →
    (metrics, out_gen)``.

    ``disc_fake`` and ``disc_real`` are compact batches with a leading
    ``training_ratio`` axis (two independent draws per discriminator
    update); ``gen_batch`` is one compact batch. Metrics stay on the
    device: ``{'gen': [total, ll, ad], 'disc': [total, true, fake]}``, the
    disc row averaged over the draws. ``out_gen`` is the generator phase's
    (N, H, W, 3) output, for the stacked generator every stage's (S, N, H,
    W, 3); the discriminator sees the last stage. The two phases are
    methods, so that a profiler can time them.
    """

    def __init__(self, config: GANConfig, state: TrainState):
        _check_train_config(config)
        self.config = config
        self.state = state
        if config.content_loss_layer != "none" and state.vgg is None:
            raise ValueError("a content loss needs the state's VGG19 "
                             "(create_state)")
        self.prepare = batch_preparer(config,
                                      next(state.gen.parameters()).device)
        for m in state.gen.modules():
            if isinstance(m, ChannelDropout):
                m.generator = state.rng

    def _sync_grads(self, params) -> None:
        """Between a phase's backward and its optimizer step: nothing on
        one device; the data-parallel step all-reduces the gradients
        here."""

    def _prepare(self, raw: dict) -> dict:
        with torch.no_grad(), span("step.prepare"):
            batch = self.prepare(raw)
        if batch["input"].shape[0] != self.config.batch_size:
            raise ValueError(f"batch of {batch['input'].shape[0]} rows, "
                             f"config.batch_size is {self.config.batch_size}")
        return batch

    def disc_phase(self, fake_raw: dict, real_raw: dict) -> torch.Tensor:
        """One discriminator update → [total, true, fake]."""
        with span("train.disc_phase", step=self.state.step):
            cfg, st = self.config, self.state
            n = cfg.batch_size
            fake, real = self._prepare(fake_raw), self._prepare(real_raw)
            with torch.no_grad():
                out_gen, _ = gen_apply(st.gen, fake, cfg)
            both = torch.cat([disc_input(real["input"], real["target"], cfg),
                              disc_input(fake["input"], out_gen, cfg)])
            res = st.disc(both)
            true_loss, fake_loss = losses.disc_adversarial_loss(
                res[:n], res[n:], cfg.gan_penalty_weight, n)
            total = true_loss + fake_loss
            st.disc_opt.zero_grad(set_to_none=True)
            with span("train.backward"):
                total.backward()
            self._sync_grads(st.disc.parameters())
            with span("train.optimizer"):
                st.disc_opt.step()
            return torch.stack([total, true_loss, fake_loss]).detach()

    def gen_phase(self, gen_raw: dict):
        """One generator update → ([total, ll, ad], out_gen: the output,
        or the stacked generator's stages stacked). Only the generator's
        parameters receive gradients."""
        with span("train.gen_phase", step=self.state.step):
            cfg, st = self.config, self.state
            batch = self._prepare(gen_raw)
            out_gen, stages = gen_apply(st.gen, batch, cfg)
            d_out = st.disc(disc_input(batch["input"], out_gen, cfg))
            ad = losses.gen_adversarial_loss(d_out, cfg.gan_penalty_weight,
                                             cfg.batch_size)
            ll = reconstruction_loss(out_gen, batch["target"], st.vgg, cfg) \
                * cfg.l1_penalty_weight
            total = ad + ll
            if cfg.tv_penalty_weight:
                total = total + cfg.tv_penalty_weight * \
                    losses.total_variation_loss(out_gen)
            st.gen_opt.zero_grad(set_to_none=True)
            with span("train.backward"):
                total.backward(inputs=list(st.gen.parameters()))
            self._sync_grads(st.gen.parameters())
            with span("train.optimizer"):
                st.gen_opt.step()
            out = torch.stack(stages) if stages else out_gen
            return torch.stack([total, ll, ad]).detach(), out.detach()

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
