"""The comparisons that decide ``correct``, and the control's precision.

Served images: each sampled image's relative gap to the reference,
‖out − ref‖₂ / ‖ref‖₂, and the worst of them.

Training (the first three steps of the timed object, followed by the
reference from the same weights, batches and dropout draws):
- ``output_gap``: the worst relative image gap of the first step's
  generator-phase output (later steps follow Adam's first update, ±lr on
  every element, whose sign rounding picks where a gradient is near zero);
- ``loss_gap``: the largest |program − reference| / |reference| of the
  two objectives (the discriminator's and the generator's total loss) of
  each of the three steps;
- ``grad_gap``: for each leaf, the gap between the norms of the first
  gradient (the program's read from Adam's first moment after one step,
  m₁ = (1 − β₁)·g), |‖g_prog‖ − ‖g_ref‖|, over the larger of the leaf's
  reference norm and the median leaf's; the worst leaf;
- ``grad_diff``: for each leaf, the norm of the first gradients'
  difference over the reference's, ‖g_prog − g_ref‖ / ‖g_ref‖; the median
  leaf: the gradients' directions as well as their sizes, which a few
  small, noisy leaves cannot decide;
- ``update_gap_net``: for each net (generator, discriminator), the gap
  between the norms of its parameters' change over the three steps,
  |‖Δp‖ − ‖Δr‖| / ‖Δr‖; the worse net (an Adam step with the wrong rate,
  moments or bias correction, or none). Most leaves are one-element norm
  scales and offsets, which Adam moves by about lr a step whatever the
  gradient's size: where a later step's gradient of one of them is near
  zero, rounding picks its sign, and the worst leaf's gap (``update_gap``,
  printed beside as a reading) jumps from under a tenth to 2/3 on an odd
  seed;
  the net's norm, summed over its large leaves, does not swing so.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by rounding alone and are left out of all of them.

The control puts the reference in the program's place, its convolutions'
operands rounded to float8 e4m3 with one scale per tensor (amax to 448):
the precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FP8_MAX = 448.0
NEGLIGIBLE = 1e-3     # of the median leaf's reference gradient norm


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, back in
    ``x``'s dtype (the gradient passes straight through)."""
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def image_gaps(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(N, ...) images → (N,) relative L2 gaps."""
    d = (out.float() - ref.float()).flatten(1).norm(dim=1)
    return d / ref.float().flatten(1).norm(dim=1).clamp(min=1e-30)


def output_gap(prog: list, ref: list) -> float:
    """Worst relative image gap of the first step's (N, H, W, 3)
    outputs."""
    return float(image_gaps(prog[0], ref[0]).max())


TOTALS = [0, 3]     # of a step's [disc total, true, fake, gen total, l1, adv]


def loss_gap(prog: list, ref: list) -> float:
    """Worst relative gap of the steps' total losses (rows of
    [disc total, true, fake, gen total, l1, adv])."""
    p = np.asarray(prog, np.float64)[:, TOTALS].ravel()
    r = np.asarray(ref, np.float64)[:, TOTALS].ravel()
    return float(np.max(np.abs(p - r) / np.maximum(np.abs(r), 1e-30)))


def _norms(leaves: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def kept_leaves(ref_grads: dict) -> list[str]:
    """Leaves whose reference gradient norm is at least NEGLIGIBLE of the
    median leaf's."""
    norms = _norms(ref_grads)
    med = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= NEGLIGIBLE * med]


def norm_gap(prog: dict, ref: dict, keep: list[str]) -> tuple[float, str]:
    """(worst |‖p‖ − ‖r‖| / max(‖r‖, median ‖r‖) over ``keep``, its
    leaf)."""
    pn, rn = _norms(prog), _norms(ref)
    med = float(np.median([rn[k] for k in keep]))
    worst, leaf = -math.inf, ""
    for k in keep:
        gap = abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def diff_gap(prog: dict, ref: dict, keep: list[str]) -> float:
    """The median over ``keep`` of ‖p − r‖ / ‖r‖."""
    return float(np.median([
        float((prog[k].double() - ref[k].double()).norm())
        / max(float(ref[k].double().norm()), 1e-30) for k in keep]))


def net_gap(prog: dict, ref: dict, keep: list[str]) -> float:
    """The worse over nets ('gen.', 'disc.' prefixes) of |‖p‖ − ‖r‖| / ‖r‖,
    each norm over the net's leaves in ``keep``."""
    worst = 0.0
    for net in sorted({k.split(".", 1)[0] for k in keep}):
        leaves = [k for k in keep if k.split(".", 1)[0] == net]
        pn = math.sqrt(sum(float(prog[k].double().norm()) ** 2
                           for k in leaves))
        rn = math.sqrt(sum(float(ref[k].double().norm()) ** 2
                           for k in leaves))
        worst = max(worst, abs(pn - rn) / max(rn, 1e-30))
    return worst
