"""The benchmark's weights: made on the device from a seed, in float32 (the
type the program keeps its parameters in), and handed to the program and
to the plain reference alike.

Glorot-uniform convolution weights (the reference's xavier init) from one
uniform draw over every convolution of a network, scaled leaf by leaf;
zero biases, unit norm weights, zero norm biases.
"""

from __future__ import annotations

import math

import torch


def glorot_bound(shape) -> float:
    """sqrt(6 / (fan_in + fan_out)) of a (out, in, k, k) or (in, out, k, k)
    weight (the sum is the same)."""
    field = math.prod(shape[2:])
    return math.sqrt(6.0 / ((shape[0] + shape[1]) * field))


def make_weights(spec, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``spec`` ((name, shape,
    kind) as ``reference.model.generator_spec`` lists them)."""
    device = torch.device(device)
    convs = [(name, shape) for name, shape, kind in spec if kind == "conv"]
    sizes = [math.prod(shape) for _, shape in convs]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.empty(sum(sizes), device=device).uniform_(
        -1.0, 1.0, generator=g)
    bounds = torch.tensor([glorot_bound(shape) for _, shape in convs],
                          device=device)
    flat *= bounds.repeat_interleave(torch.tensor(sizes, device=device))
    out = dict(zip((name for name, _ in convs),
                   (piece.view(shape) for piece, (_, shape)
                    in zip(flat.split(sizes), convs))))
    for name, shape, kind in spec:
        if kind != "conv":
            fill = 1.0 if kind == "norm_w" else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return {name: out[name] for name, _, _ in spec}
