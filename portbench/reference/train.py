"""The plain reference of one two-phase GAN training step, float32.

A step, with ``training_ratio`` 1: the discriminator update on a fake-path
draw (the generator forward without gradient, channel dropout on) and an
independent real draw, then the generator update (the reconstruction
loss × ``l1_weight`` plus the saturating adversarial loss), both with
Adam (lr, betas (0.5, 0.999), eps 1e-8). The reconstruction loss is L1,
or with a content layer ``content.content_loss`` (the nearest-neighbour
distance between the two images' VGG19 features) in its place. Losses as
the reference code scales them: ``gan_weight / N · Σ_i
mean_patches(-log(D_i + 1e-7))`` (real side), the fake side with ``1 -
D``.

``recipe`` reads a configuration file's dict and refuses, naming the key,
a recipe that this reference does not compute.
"""

from __future__ import annotations

import dataclasses

import torch

from . import content, model

EPS = 1e-7
BETAS = (0.5, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass
class Adam:
    """Plain Adam over a dict of leaves."""
    lr: float
    m: dict = dataclasses.field(default_factory=dict)
    v: dict = dataclasses.field(default_factory=dict)
    t: int = 0

    def update(self, params: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = BETAS
        c1 = 1.0 - b1 ** self.t
        c2 = 1.0 - b2 ** self.t
        for name, g in grads.items():
            m = self.m.get(name, torch.zeros_like(g)) * b1 + g * (1.0 - b1)
            v = self.v.get(name, torch.zeros_like(g)) * b2 + g * g * (1.0 - b2)
            self.m[name], self.v[name] = m, v
            step = (m / c1) / ((v / c2).sqrt() + ADAM_EPS)
            params[name] = (params[name] - self.lr * step).detach()


@dataclasses.dataclass
class Recipe:
    image_size: tuple
    pose_dim: int
    learning_rate: float = 2e-4
    l1_weight: float = 100.0
    gan_weight: float = 1.0
    affine_dtype: torch.dtype = torch.float32
    content_layer: str = "none"     # or a VGG19 layer, 'block1_conv2'
    nn_area: int = 1


# keys of a configuration file that describe it and set nothing here
DESCRIPTIVE = ("name", "source", "published_as", "num_transforms",
               "encoder_filters", "decoder_filters", "published_batch_size",
               "assumed", "reduced")
# keys whose only value this reference computes, with that value
FIXED = {"use_input_pose": True, "warp_skip": "mask", "warp_agg": "max",
         "gen_type": "baseline", "training_ratio": 1,
         "adam_betas": list(BETAS)}
# keys read into the recipe, and what they become
READ = {"image_size": ("image_size", tuple),
        "pose_dim": ("pose_dim", int),
        "learning_rate": ("learning_rate", float),
        "l1_penalty_weight": ("l1_weight", float),
        "gan_penalty_weight": ("gan_weight", float),
        "compute_dtype": ("affine_dtype", lambda v: getattr(torch, v)),
        "content_loss_layer": ("content_layer", str),
        "nn_loss_area_size": ("nn_area", int)}


def recipe(config: dict) -> Recipe:
    """The ``Recipe`` of a configuration file's dict. Raises, naming the
    key, on a recipe this reference does not compute: a key it neither
    reads nor knows as descriptive, or a value other than ``FIXED``'s
    (``num_stacks`` is the stacked generator's, which is refused)."""
    kwargs = {}
    for key, value in config.items():
        if key in READ:
            field, cast = READ[key]
            kwargs[field] = cast(value)
        elif key in FIXED:
            if value != FIXED[key]:
                raise ValueError(f"the reference computes {key} "
                                 f"{FIXED[key]!r} only, not {value!r}")
        elif key not in DESCRIPTIVE and key != "num_stacks" \
                and not key.endswith("_parameters"):
            raise ValueError(f"the reference does not compute the "
                             f"configuration key {key!r}")
    out = Recipe(**kwargs)
    if out.content_layer != "none":
        content.layer_index(out.content_layer)
    if out.nn_area < 1:
        raise ValueError(f"nn_loss_area_size {out.nn_area} is under 1")
    return out


def _grads(loss, params: dict) -> dict:
    leaves = [p.requires_grad_(True) for p in params.values()]
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return dict(zip(params, grads))


def train_step(gen_p: dict, disc_p: dict, gen_opt: Adam, disc_opt: Adam,
               fake: dict, real: dict, gen_batch: dict, recipe: Recipe,
               dropout: torch.Generator, q=model.ident,
               loss_rows: int | None = None, vgg: dict | None = None) -> dict:
    """One step on prepared batches (``model.prepare``), updating the
    parameter dicts in place → {'disc': [total, true, fake], 'gen':
    [total, reconstruction, adversarial], 'out': the generator phase's
    output, 'disc_grads', 'gen_grads'}. ``vgg``: the VGG19 weights
    (``content.vgg_spec``) of a recipe with a content layer.
    ``loss_rows`` takes every loss over the first rows alone, the forward
    left whole: a planted fault."""
    size, k = recipe.image_size, recipe.pose_dim
    n = fake["input"].shape[0]
    h = n if loss_rows is None else loss_rows
    w = recipe.gan_weight
    with torch.no_grad():
        out_fake = model.generator(gen_p, fake, size, k, q, dropout,
                                   recipe.affine_dtype)
    both = torch.cat([model.disc_input(real["input"], real["target"], k),
                      model.disc_input(fake["input"], out_fake, k)])
    for p in disc_p.values():
        p.requires_grad_(True)
    res = model.discriminator(disc_p, both, q)
    true_l = (-torch.log(res[:h] + EPS)).mean(-1).sum() * w / h
    fake_l = (-torch.log(1.0 - res[n:n + h] + EPS)).mean(-1).sum() * w / h
    disc_total = true_l + fake_l
    disc_grads = _grads(disc_total, disc_p)
    disc_opt.update(disc_p, disc_grads)

    for p in gen_p.values():
        p.requires_grad_(True)
    out = model.generator(gen_p, gen_batch, size, k, q, dropout,
                          recipe.affine_dtype)
    d = model.discriminator(disc_p, model.disc_input(gen_batch["input"],
                                                     out, k), q)
    adv = (-torch.log(d[:h] + EPS)).mean(-1).sum() * w / h
    if recipe.content_layer == "none":
        recon = (out[:h] - gen_batch["target"][:h]).abs().mean()
    else:
        recon = content.content_loss(vgg, out[:h], gen_batch["target"][:h],
                                     recipe.content_layer, recipe.nn_area, q)
    l1 = recon * recipe.l1_weight
    gen_total = adv + l1
    gen_grads = _grads(gen_total, gen_p)
    gen_opt.update(gen_p, gen_grads)

    def nums(*xs):
        return [float(x.detach()) for x in xs]

    return {"disc": nums(disc_total, true_l, fake_l),
            "gen": nums(gen_total, l1, adv), "out": out.detach(),
            "disc_grads": disc_grads, "gen_grads": gen_grads}
