"""The fold's branch table at the benchmark cells' skip stages.

``ops.warp.plan_folds`` on the four warped stages of fashion-256 (pose_dim
18) and h36m-224 (pose_dim 16, parts 1-5 statically empty), windowed, under
each placement, at masks whose parts fit their windows: the kernel-placed
fold where the placement kernel takes the shape, the XLA-style placement at
h36m's 112² (its windows' width is not a multiple of the kernel's x
alignment), the full scan below 64² (too small to window); 'xla' places
every windowable stage itself. The auto windowed rule turns the windowed
fold on for both cells' batch of 32 on the card. This file imports no JAX.
"""

import pytest
import torch

from pose_transfer_torch.core.transforms_host import static_empty_parts
from pose_transfer_torch.ops import warp as twarp
from pose_transfer_torch.train.engine import GANConfig, auto_windowed

N, T = 2, 10
# (image side, pose_dim, the warped skips' (side, channels))
CELLS = {"fashion": (256, 18, ((256, 64), (128, 128), (64, 256), (32, 512))),
         "h36m": (224, 16, ((224, 64), (112, 128), (56, 256), (28, 512)))}
BRANCHES = {"fashion": ("place", "place", "place", "scan"),
            "h36m": ("place", "xla", "scan", "scan")}


def _masks(side, static_empty):
    """The body everywhere; every other part a box of a quarter side, so
    that it fits its window at every stage; static-empty parts empty."""
    masks = torch.zeros((N, T, side, side))
    masks[:, 0] = 1.0
    for i in range(1, T):
        if i not in static_empty:
            y, x = (17 * i) % (side // 2), (29 * i) % (side // 2)
            masks[:, i, y:y + side // 4, x:x + side // 4] = 1.0
    return masks


@pytest.mark.parametrize("place", ["auto", "kernel", "xla"])
@pytest.mark.parametrize("dataset", ["fashion", "h36m"])
def test_cells_branch_table(dataset, place):
    side, pose_dim, stages = CELLS[dataset]
    static = static_empty_parts(pose_dim)
    warps = torch.tensor([1, 0, 0, 0, 1, 0, 0, 0], dtype=torch.bfloat16) \
        .expand(N, T, 8)
    plans = twarp.plan_folds([(N, s, s, c) for s, c in stages], warps,
                             _masks(side, static), torch.bfloat16,
                             windowed=True, static_empty=static,
                             place_impl=place)
    want = BRANCHES[dataset]
    if place == "xla":
        want = tuple("xla" if b == "place" else b for b in want)
    assert tuple(p.branch for p in plans) == want
    assert all((p.windows is None) == (p.branch == "scan") for p in plans)
    config = GANConfig(image_size=(side, side), pose_dim=pose_dim,
                       batch_size=32, warp_place=place)
    assert auto_windowed(config, torch.device("cuda"))
    assert auto_windowed(config, torch.device("cpu"))
    assert auto_windowed(GANConfig(batch_size=8, warp_place=place),
                         torch.device("cuda")) == (place != "xla")
