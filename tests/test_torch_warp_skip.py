"""The skip rules of the fused warp fold's CUDA kernels, on the CPU, and
the helpers with which ``chip_smoke.py`` checks and times those kernels.

``csrc/warp_fold.cu`` folds zm = +0 without taps where a part's mask is 0
(only for the first such part of a pixel: later ones are passed over);
``csrc/warp_fold_bwd.cu`` skips a (tile, part) pair when no output pixel
with a nonzero mask reaches the tile, judged first by a box that
``ops/warp_pallas.py::bwd_boxes`` computes as the kernel does. Neither
kernel runs here, so these tests hold the rules themselves: the forward's
against the plain forward (the same ``out`` but for the sign of zeros, the
same ``idx``), the backward's box and index windows against brute force
over the plain version's ramps, at 64² and at the 16×128 shape of the
``cuda`` tests, with sheared, scaled (0.3-3), near-zero-slope and sentinel
transforms. Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pose_transfer_torch.ops import warp_pallas as twp

torch.set_num_threads(2)

_TD = {"float32": (torch.float32, torch.int32),
       "bfloat16": (torch.bfloat16, torch.int16)}


def _transforms(n, t, h, seed):
    """(n, t, 8) f32 transforms: the identity, a shear with scale, the
    translation-by-1000 sentinel, scales 0.3 and 3, a near-zero slope on
    each axis, then random affines (scale 0.3-3, shear ±1, shift ±h/4)."""
    rng = np.random.default_rng(seed)
    fixed = [[1, 0, 0, 0, 1, 0], [0.9, 0.6, 2.0, -0.7, 1.1, -1.0],
             [1, 0, 1000.0, 0, 1, 1000.0], [0.3, 0.1, 5.0, 0.0, 0.3, 3.0],
             [3.0, -0.2, -4.0, 0.3, 3.0, -7.0],
             [1.0, 0.2, 1.5, 0.1, 5e-4, 4.0],
             [2e-4, 0.0, 6.0, 0.2, 1.2, -2.0]]
    warps = np.zeros((n, t, 8), np.float32)
    for k in range(t):
        for i in range(n):
            if k < len(fixed):
                warps[i, k, :6] = fixed[k]
            else:
                s = rng.uniform(0.3, 3.0, 2) * rng.choice([-1, 1], 2)
                sh = rng.uniform(-1, 1, 2)
                warps[i, k, :6] = [s[0], sh[0], rng.uniform(-h / 4, h / 4),
                                   sh[1], s[1], rng.uniform(-h / 4, h / 4)]
    return torch.tensor(warps)


def _tile_masks(n, t, h, w, seed):
    """Masks from {0, ½, 1}, each part 0 outside a random block of rows and
    columns (0 over whole tiles, and over single pixels inside it); part 0
    all ones; part 4 repeats part 3's mask (with an equal transform: an
    exact tie)."""
    rng = np.random.default_rng(seed)
    masks = rng.choice([0.0, 0.5, 1.0], size=(n, t, h, w))
    masks[:, 0] = 1.0
    for i in range(n):
        for k in range(1, t):
            keep = np.zeros((h, w))
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            keep[y0:y0 + rng.integers(2, h // 2),
                 x0:x0 + rng.integers(4, w // 2)] = 1.0
            masks[i, k] *= keep
    masks[:, 4] = masks[:, 3]
    return torch.tensor(masks, dtype=torch.float32)


def _skipping_forward(features, warps, masks, rule):
    """The plain forward with the kernel's skip: zm = +0 where the part's
    mask is 0, for every such part (``rule`` "every_zero_part") or, as the
    kernel does, for the first such part of a pixel only, later ones
    leaving the fold as it is ("first_zero_part_only")."""
    zero = masks == 0
    seen = torch.zeros_like(zero[:, 0])
    out = idx = None
    for t in range(warps.shape[1]):
        z = twp._warp_part(features, warps[:, t])
        zm = (z * masks[:, t].float()[..., None]).to(features.dtype)
        zm = torch.where(zero[:, t, ..., None], torch.zeros_like(zm), zm)
        passed = zero[:, t] & seen if rule == "first_zero_part_only" \
            else torch.zeros_like(seen)
        seen |= zero[:, t]
        if t == 0:
            out, idx = zm, torch.zeros(zm.shape, dtype=torch.int8)
            continue
        take = (zm.float() > out.float()) & ~passed[..., None]
        out = torch.where(take, zm, out)
        idx = torch.where(take, torch.full_like(idx, t), idx)
    return out, idx


@pytest.mark.parametrize("rule", ["every_zero_part", "first_zero_part_only"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_skip_changes_only_zero_signs(dtype, rule):
    """Folding +0 for a zero-mask part (and passing over the later ones)
    leaves ``out`` bit for bit as the plain version's once −0 is mapped to
    +0, and ``idx`` bit for bit: the compare is a strict f32 '>' and
    +0 == −0, and once +0 is folded the running max is ≥ +0, which a later
    +0 cannot beat. Some zeros do change sign, so the check is not vacuous;
    ties go to the earlier part."""
    td, bits = _TD[dtype]
    n, t, h, w, c = 2, 8, 16, 128, 16
    rng = np.random.default_rng(1)
    f = torch.tensor(rng.standard_normal((n, h, w, c)),
                     dtype=torch.float32).to(td)
    warps = _transforms(n, t, h, 2)
    warps[:, 4] = warps[:, 3]
    masks = _tile_masks(n, t, h, w, 3).to(td)
    ref, ref_idx = twp.warp_fold_pallas_reference(f, warps, masks)
    out, idx = _skipping_forward(f, warps, masks, rule)
    assert torch.equal((out + 0.0).view(bits), (ref + 0.0).view(bits))
    assert torch.equal(idx, ref_idx)
    assert (out.view(bits) != ref.view(bits)).any()
    assert (idx == 3).any() and not (idx == 4).any()


def _brute_region(warps_t, h, w):
    """(N, tiles_y, tiles_x, H, W): the output pixels (o, xo) with a
    nonzero weight to some df pixel of each BWD_TILE tile, from the plain
    version's dense ramps: wy[x, o, y] ≠ 0 and wx[o, xo, x] ≠ 0."""
    ty_, tx_ = twp.BWD_TILE
    a = (twp._ramp(twp._v_pos(warps_t, h, w), h) != 0).float()  # n x o y
    b = (twp._ramp(twp._u_pos(warps_t, h, w), w) != 0).float()  # n o xo x
    n = a.shape[0]
    ay = a.view(n, w, h, -1, ty_).amax(4)                       # n x o ty
    region = []
    for x0 in range(0, w, tx_):
        xs = slice(x0, x0 + tx_)
        region.append(torch.einsum("nxot,nowx->ntow", ay[:, xs], b[..., xs])
                      > 0)
    return torch.stack(region, 2)


@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 16, 128)])
def test_backward_box_holds_every_reaching_output(shape):
    """Every output pixel whose taps give a df tile a nonzero weight lies
    in that tile's box (``bwd_boxes``), for every transform kind."""
    n, h, w = shape
    warps = _transforms(n, 12, h, 4)
    for t in range(warps.shape[1]):
        region = _brute_region(warps[:, t], h, w)
        box = twp.bwd_boxes(warps[:, t], h, w)
        lo_o, hi_o, lo_x, hi_x = (box[..., i, None, None] for i in range(4))
        o = torch.arange(h)[:, None]
        xo = torch.arange(w)[None, :]
        inside = (o >= lo_o) & (o <= hi_o) & (xo >= lo_x) & (xo <= hi_x)
        assert not (region & ~inside).any(), t
        if t == 0:
            assert region.any()


@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 16, 128)])
def test_backward_windows_hold_every_tap(shape):
    """The index windows the kernel narrows to exact intervals
    (``_window``) hold every nonzero ramp weight: the rows o of each column
    x with a weight to a row of a tile, and the columns xo of each (o, x)
    with a weight to x."""
    n, h, w = shape
    warps = _transforms(n, 12, h, 5)
    ty_ = twp.BWD_TILE[0]
    for t in range(warps.shape[1]):
        tr = warps[:, t]
        m00, m01, tx, m10, m11, ty = (tr[:, i] for i in range(6))
        wy = twp._ramp(twp._v_pos(tr, h, w), h) != 0           # n x o y
        xs = torch.arange(w, dtype=torch.float32)
        off_y = (ty - 0.5).double()[:, None] \
            + (m10[:, None] * (xs + 0.5)).double()              # n x
        for y_a in range(0, h, ty_):
            lo, hi = twp._window(m11[:, None], off_y, off_y, y_a,
                                 min(y_a + ty_, h) - 1, h)       # n x
            rows = wy[..., y_a:y_a + ty_].any(-1)                # n x o
            o = torch.arange(h)
            assert not (rows & ((o < lo[..., None]) | (o > hi[..., None]))
                        ).any(), (t, y_a)
        wx = twp._ramp(twp._u_pos(tr, h, w), w) != 0           # n o xo x
        os_ = torch.arange(h, dtype=torch.float32)
        off_x = (tx - 0.5).double()[:, None, None] \
            + (m01[:, None] * (os_ + 0.5)).double()[..., None]   # n o 1
        x = torch.arange(w)
        lo, hi = twp._window(m00[:, None, None], off_x, off_x, x, x, w)
        xo = torch.arange(w)[:, None]                            # xo x
        outside = (xo < lo[:, :, None, :]) | (xo > hi[:, :, None, :])
        assert not (wx & outside).any(), t


def test_main_path_inputs():
    """``chip_smoke.main_path_inputs``, built as a step builds them (here
    at 64²×8, N = 2, on the CPU): part 0's mask all ones, the other parts'
    sparse, so that most (tile, part) pairs of parts 1-9 are 0 over a whole
    4×8 tile; transforms scaled as the fused fold takes them."""
    f, warps, masks = chip_smoke.main_path_inputs(64, 8, torch.bfloat16,
                                                  device="cpu", batch=2)
    assert f.shape == (2, 64, 64, 8) and f.dtype == torch.bfloat16
    assert warps.shape == (2, 10, 8) and warps.dtype == torch.float32
    assert masks.shape == (2, 10, 64, 64) and masks.dtype == torch.bfloat16
    live = (masks != 0).float().mean((0, 2, 3))
    assert live[0] == 1.0 and (live[1:] < 0.2).all()
    tiles = (masks[:, 1:] != 0).view(2, 9, 16, 4, 8, 8).any(5).any(3)
    assert (~tiles).float().mean() > 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_checks(dtype):
    """The kernel checks of ``chip_smoke.py``: ``fwd_same`` passes a −0 for
    +0 but no other difference, nor a different argmax; ``bwd_within``
    holds f32 to 1e-6 of the largest element and bf16 to two ulps of each
    element."""
    td, _ = _TD[dtype]
    ref = torch.tensor([[0.0, -1.5, 2.0, 0.25]]).to(td)
    idx = torch.tensor([[0, 1, 2, 3]], dtype=torch.int8)
    signed = torch.tensor([[-0.0, -1.5, 2.0, 0.25]]).to(td)
    assert chip_smoke.fwd_same(signed, idx, ref, idx)
    assert chip_smoke.fwd_same(signed, None, ref, None)
    assert not chip_smoke.fwd_same(signed, idx + 1, ref, idx)
    moved = torch.tensor([[0.0, -1.5, 2.0, 0.375]]).to(td)
    assert not chip_smoke.fwd_same(moved, idx, ref, idx)
    big = torch.tensor([1.0, 1000.0]).to(td)
    if dtype == "float32":
        assert chip_smoke.bwd_within(big + 5e-4, big)
        assert not chip_smoke.bwd_within(big + 2e-3, big)
    else:
        two_ulps = torch.tensor([1.0 + 2 ** -6, 1000.0]).to(td)
        three_ulps = torch.tensor([1.0 + 3 * 2 ** -7, 1000.0]).to(td)
        assert chip_smoke.bwd_within(two_ulps, big)
        assert not chip_smoke.bwd_within(three_ulps, big)


@pytest.mark.parametrize("kernel", ["warp_fold", "warp_fold_bwd"])
def test_stats_refused_on_the_cpu(kernel):
    """The skip counts are the CUDA kernel's own: a CPU call (the plain
    version, which skips nothing) refuses a stats buffer."""
    n, t, h, w, c = 1, 3, 8, 16, 8
    f = torch.zeros((n, h, w, c))
    warps = torch.zeros((n, t, 8))
    masks = torch.ones((n, t, h, w))
    stats = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="stats"):
        if kernel == "warp_fold":
            twp.warp_fold(f, warps, masks, True, stats)
        else:
            twp.warp_fold_bwd(f, warps, masks,
                              torch.zeros(f.shape, dtype=torch.int8), stats)


def test_load_baseline_is_a_package_of_its_own():
    """``chip_smoke.load_baseline`` (the ``--baseline`` A/B) imports another
    checkout's fused fold as its own package: here the repo itself, whose
    copy launches nothing through this one's modules, builds into the
    checkout's own build directory and, on the CPU, computes the plain
    version's result."""
    import os
    from pose_transfer_torch.ops import warp_fused
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = chip_smoke.load_baseline(root)
    assert base.__name__ == "baseline_pose_transfer_torch.ops.warp_pallas"
    assert base.warp_fold is not twp.warp_fold
    assert base.warp_fused is not warp_fused
    f, warps, masks = _torch_inputs(1, 6, 8, 16, 8, 9)
    out, idx = base.warp_fold(f, warps, masks)
    ref, ref_idx = twp.warp_fold_pallas_reference(f, warps, masks)
    assert torch.equal(out, ref) and torch.equal(idx, ref_idx)
    assert base.LAUNCHES is not twp.LAUNCHES


def _torch_inputs(n, t, h, w, c, seed):
    rng = np.random.default_rng(seed)
    f = torch.tensor(rng.standard_normal((n, h, w, c)), dtype=torch.float32)
    return f, _transforms(n, t, h, seed), _tile_masks(n, t, h, w, seed)
