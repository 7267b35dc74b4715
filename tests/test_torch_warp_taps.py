"""The two-pass warp's tap kernels, ``warp_taps`` and ``warp_taps_t``.

CPU: the plain tap versions (``warp_taps_reference``,
``warp_taps_t_reference``; the wrappers take CUDA tensors only) against
the banded products of ``ops/warp.py`` (``_warp_win_banded``,
``_warp_win_t_banded``), on transforms that exercise the taps' edge cases:
identity, rotation, up- and down-scaling, flips, m00 = 0, windows at and
past every edge, a transform that maps wholly outside, one part and nine.
- forward: bitwise in bf16 (the CPU's bf16 matmul sums the two nonzero
  products of each pass in f32 and rounds once, as the taps do); in f32
  within 4 ulps of the output's scale (its f32 matmul fuses multiply and
  add where the taps round each product);
- transpose: both ``joint`` modes within f32 tolerance (the sums run in
  another order), the bf16 roundings of pass 1 (and of pass 2 without
  ``joint``) within one bf16 rounding;
- the adjoint identity <A x, y> = <x, A^T y> in f32.

CUDA (``-m cuda``, skipped without a card): the kernels against the plain
tap versions at the benchmark cells' stage shapes at batch 2 (the forward
bitwise, the transpose within tolerance), against the banded products
(within one bf16 rounding), ``affine_transform_layer``'s output and
feature gradient on the 'place', 'xla' and 'scan' branches against the same
folds on the banded products, the launch counters and the refusal under
grad mode. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from pose_transfer_torch.ops import warp as W
from pose_transfer_torch.ops import warp_fused as WF

torch.set_num_threads(2)

CASES = ("identity", "rotation", "upscale", "downscale", "flip", "m00_zero",
         "edges", "outside")


def _matrix(case, rng, h, w):
    """One part's inverse affine (m00, m01, tx, m10, m11, ty) in pixels."""
    cy, cx = h / 2, w / 2
    if case == "identity":
        return (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
    if case == "rotation":
        a = rng.uniform(0.2, 0.6) * rng.choice([-1, 1])
        m = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    elif case == "upscale":
        m = np.diag(rng.uniform(0.3, 0.7, 2))
    elif case == "downscale":
        m = np.diag(rng.uniform(1.4, 2.5, 2))
    elif case == "flip":
        m = np.array([[-rng.uniform(0.6, 1.4), rng.uniform(-0.2, 0.2)],
                      [rng.uniform(-0.2, 0.2), -rng.uniform(0.6, 1.4)]])
    elif case == "m00_zero":
        m = np.array([[0.0, rng.uniform(0.5, 1.2)],
                      [rng.uniform(0.5, 1.2), rng.uniform(-0.1, 0.1)]])
    elif case == "outside":
        return (1.0, 0.0, 5.0 * w, 0.0, 1.0, -5.0 * h)
    else:        # edges: mild affines, the windows do the work
        m = np.eye(2) + rng.uniform(-0.15, 0.15, (2, 2))
    # the map's center to near the center
    t = np.array([cx, cy]) - m @ np.array([cx, cy]) \
        + rng.uniform(-3, 3, 2)
    return (m[0, 0], m[0, 1], t[0], m[1, 0], m[1, 1], t[1])


def _inputs(case, dtype, n=2, p=3, h=20, w=24, c=8, s_y=10, s_x=12,
            seed=0):
    """(features, warps (N, P, 8), y0, x0, s_y, s_x, init_image_size): the
    transforms in pixels of the (h, w) map, in ``dtype`` as the fold takes
    them; windows at random starts, or for 'edges' at and past every edge."""
    rng = np.random.default_rng(seed)
    f = torch.tensor(rng.standard_normal((n, h, w, c)),
                     dtype=torch.float32).to(dtype)
    warps = torch.zeros((n, p, 8))
    for i in range(n):
        for j in range(p):
            warps[i, j, :6] = torch.tensor(_matrix(case, rng, h, w))
    if case == "edges":
        ys = [0, h - s_y, -3, h - 2, 5]
        xs = [w - s_x, 0, w - 3, -4, 7]
        y0 = torch.tensor([[ys[(i + j) % 5] for j in range(p)]
                           for i in range(n)])
        x0 = torch.tensor([[xs[(i + 2 * j) % 5] for j in range(p)]
                           for i in range(n)])
    else:
        y0 = torch.tensor(rng.integers(0, h - s_y + 1, (n, p)))
        x0 = torch.tensor(rng.integers(0, w - s_x + 1, (n, p)))
    return f, warps.to(dtype), y0, x0, s_y, s_x, (h, w)


def _coeffs(f, warps, y0, x0, init):
    return W._tap_coeffs(warps, f.shape[1], f.shape[2], init, y0, x0)


def _ulps_f32(diff, ref, k):
    """|diff| within k f32 ulps of the reference's largest magnitude."""
    return bool(diff.abs().max() <= k * 2.0 ** -23
                * max(ref.abs().max().item(), 1e-30))


@pytest.mark.parametrize("parts", [1, 9])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_matches_banded(dtype, case, parts):
    f, warps, y0, x0, s_y, s_x, init = _inputs(case, dtype, p=parts)
    ref = W._warp_win_banded(f, warps, y0, x0, s_y, s_x, init)
    out = WF.warp_taps_reference(f, _coeffs(f, warps, y0, x0, init), s_y,
                                 s_x)
    assert out.shape == ref.shape and out.dtype == dtype
    if dtype == torch.bfloat16:
        assert torch.equal(out, ref)
    else:
        assert _ulps_f32(out - ref, ref, 4)
    if case == "outside":
        assert not out.any()
    else:
        assert out.abs().sum() > 0


def _transpose_pair(case, dtype, joint, parts, seed=0):
    f, warps, y0, x0, s_y, s_x, init = _inputs(case, dtype, p=parts,
                                               seed=seed)
    h, w = f.shape[1:3]
    rng = np.random.default_rng(seed + 1)
    g = torch.tensor(rng.standard_normal((f.shape[0], parts, s_y, s_x,
                                          f.shape[3])),
                     dtype=torch.float32).to(dtype)
    ref = W._warp_win_t_banded(g, warps, y0, x0, h, w, init, joint)
    out = WF.warp_taps_t_reference(g, _coeffs(f, warps, y0, x0, init), h, w,
                                   joint)
    return out, ref


@pytest.mark.parametrize("joint", [True, False])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_transpose_matches_banded(dtype, case, joint):
    # the full map's transpose (joint=False) is only taken with one part
    parts = 9 if joint else 1
    out, ref = _transpose_pair(case, dtype, joint, parts)
    assert out.shape == ref.shape
    assert out.dtype == (torch.float32 if joint else dtype)
    diff = (out.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    if dtype == torch.float32:
        # sums of up to ~20 products a pass, in another order
        assert _ulps_f32(diff, ref.float(), 64)
    else:
        # pass 1's (and without joint pass 2's) rounding to bf16 may flip
        # where the f32 sums differ in their last bit: one bf16 rounding
        # of the largest value
        assert diff.max() <= 2.0 ** -8 * scale
        assert (diff > 64 * 2.0 ** -23 * scale).float().mean() < 0.01
    if case == "outside":
        assert not out.any()
    else:
        assert scale > 0


@pytest.mark.parametrize("case", CASES)
def test_transpose_is_the_adjoint(case):
    f, warps, y0, x0, s_y, s_x, init = _inputs(case, torch.float32, p=9,
                                               seed=3)
    h, w = f.shape[1:3]
    co = _coeffs(f, warps, y0, x0, init)
    rng = np.random.default_rng(4)
    g = torch.tensor(rng.standard_normal((f.shape[0], 9, s_y, s_x,
                                          f.shape[3])), dtype=torch.float32)
    lhs = (WF.warp_taps_reference(f, co, s_y, s_x).double()
           * g.double()).sum()
    rhs = (f.double()
           * WF.warp_taps_t_reference(g, co, h, w, True).double()).sum()
    norm = (f.double().norm() * g.double().norm()).item()
    assert abs(lhs.item() - rhs.item()) <= 1e-6 * norm


def test_full_map_is_the_window_at_the_origin():
    """``_warp_full`` / ``_warp_full_t`` (P = 1, window = map): the taps at
    the full map agree with the banded full-map warps."""
    f, warps, _, _, _, _, init = _inputs("rotation", torch.bfloat16, p=1)
    n, h, w, _ = f.shape
    zero = torch.zeros((n, 1), dtype=torch.int64)
    ref = W._warp_win_banded(f, warps, zero, zero, h, w, init)[:, 0]
    co = _coeffs(f, warps, zero, zero, init)
    assert torch.equal(WF.warp_taps_reference(f, co, h, w)[:, 0], ref)
    assert torch.equal(W._warp_full(f, warps[:, 0], init), ref)
    g = ref.clone()
    df = WF.warp_taps_t_reference(g[:, None], co, h, w, False)
    df_ref = W._warp_win_t_banded(g[:, None], warps, zero, zero, h, w, init,
                                  False)
    assert (df.float() - df_ref.float()).abs().max() \
        <= 2.0 ** -8 * df_ref.float().abs().max()


def test_wrappers_check_inputs_and_refuse_grad():
    f, warps, y0, x0, s_y, s_x, init = _inputs("rotation", torch.float32)
    co = _coeffs(f, warps, y0, x0, init)
    before = dict(WF.LAUNCHES)
    fg = f.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        WF.warp_taps(fg, co, s_y, s_x)
    g = torch.zeros((2, 3, s_y, s_x, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        WF.warp_taps_t(g, co, 20, 24, True)
    # no grad mode: no refusal; the wrappers take CUDA tensors only (the
    # CPU runs the banded products, ``ops.warp._warp_win``)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        WF.warp_taps(fg, co, s_y, s_x)
    with pytest.raises(ValueError, match="CUDA device"):
        WF.warp_taps_t(g.detach(), co, 20, 24, True)
    with pytest.raises(TypeError, match="dtype"):
        WF.warp_taps(f.double(), co, s_y, s_x)
    with pytest.raises(ValueError, match="coeffs"):
        WF.warp_taps(f, co[..., :6], s_y, s_x)
    with pytest.raises(ValueError, match="coeffs"):
        WF.warp_taps_t(g.detach()[:, :2], co, 20, 24, True)
    assert WF.LAUNCHES == before


# ---------------------------------------------------------------- CUDA ---

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# the benchmark cells' fold stages: (image, pose_dim, stage); fashion-256
# kernel-places 256², 128², 64² and scans 32²; h36m-224 kernel-places 224²,
# places 112² XLA-style and scans 56², 28²
STAGES = [((256, 256), 18, 0), ((256, 256), 18, 1), ((256, 256), 18, 2),
          ((256, 256), 18, 3), ((224, 224), 16, 0), ((224, 224), 16, 1),
          ((224, 224), 16, 2), ((224, 224), 16, 3)]


def _stage_inputs(image, pose_dim, stage, dtype, dev, batch=2, seed=0):
    from pose_transfer_torch.tools import bench_fold
    feats, warps, masks = bench_fold._fold_inputs(batch, image, pose_dim,
                                                  stage, dtype, dev, seed)
    return feats, warps.to(dtype), masks


def _stage_calls(feats, warps, masks, image):
    """The (coeffs, s_y, s_x) of the stage's window warps (the placement
    kernel's windows where the stage takes them, else the XLA-style ones,
    where the stage is windowable) and of its full map."""
    n, h, w, _ = feats.shape
    calls = []
    if W._windowable(h, w):
        sizes = W._kernel_window_sizes(h, w)
        s_y, s_x = sizes or (h // 2, w // 2)
        masks_r = W.resize_bilinear(masks.to(feats.dtype), (h, w))
        y0, x0, _, _ = W._support_windows(masks_r, s_y, s_x,
                                          WF.X_ALIGN if sizes else 1)
        calls.append((W._tap_coeffs(warps[:, 1:], h, w, image, y0[:, 1:],
                                    x0[:, 1:]), s_y, s_x))
    zero = torch.zeros((n, 1), dtype=torch.int64, device=feats.device)
    calls.append((W._tap_coeffs(warps[:, :1], h, w, image, zero, zero), h,
                  w))
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stage", STAGES)
def test_cuda_kernels_match_plain_and_banded(stage, dtype):
    dev = _cuda()
    image, pose_dim, k = stage
    feats, warps, masks = _stage_inputs(image, pose_dim, k, dtype, dev)
    n, h, w, c = feats.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for co, s_y, s_x in _stage_calls(feats, warps, masks, image):
        p = co.shape[1]
        before = dict(WF.LAUNCHES)
        out = WF.warp_taps(feats, co, s_y, s_x)
        torch.cuda.synchronize()
        assert WF.LAUNCHES["warp_taps"] == before["warp_taps"] + 1
        assert torch.equal(out, WF.warp_taps_reference(feats, co, s_y, s_x))
        y0, x0 = co[..., 6].long(), co[..., 7].long()
        wp = warps[:, 1:] if p > 1 else warps[:, :1]
        banded = W._warp_win_banded(feats, wp, y0, x0, s_y, s_x, image)
        diff = (out.float() - banded.float()).abs()
        scale = banded.float().abs().max().item()
        assert scale > 0
        # bf16: one rounding (2^-8) of the largest magnitude. cuBLAS's f32
        # sum of a pass's two products may round otherwise and flip a bf16
        # rounding, rarely: on an H100 the largest difference read 0.25 of
        # an ulp of the largest magnitude (a flip in a lower binade), over
        # four seeds of every stage here
        assert diff.max() <= (2.0 ** -8 if dtype == torch.bfloat16
                              else 2.0 ** -20) * scale
        g = torch.randn((n, p, s_y, s_x, c), generator=gen, device=dev) \
            .to(dtype)
        for joint in (True, False) if p == 1 else (True,):
            df = WF.warp_taps_t(g, co, h, w, joint)
            torch.cuda.synchronize()
            assert WF.LAUNCHES["warp_taps_t"] > before["warp_taps_t"]
            ref = WF.warp_taps_t_reference(g, co, h, w, joint).float()
            rb = W._warp_win_t_banded(g, wp, y0, x0, h, w, image,
                                      joint).float()
            sc = ref.abs().max().item()
            assert sc > 0
            # bf16: one rounding of the largest magnitude, in both modes
            tol = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -18
            assert (df.float() - ref).abs().max() <= tol * sc
            assert (df.float() - rb).abs().max() <= tol * sc
            # deterministic: no atomics
            assert torch.equal(df, WF.warp_taps_t(g, co, h, w, joint))


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["place", "xla", "scan"])
def test_cuda_fold_branches_match_banded(branch):
    dev = _cuda()
    image, pose_dim = (256, 256), 18
    stage = 3 if branch == "scan" else 0
    feats, warps, masks = _stage_inputs(image, pose_dim, stage,
                                        torch.float32, dev)
    place = "xla" if branch == "xla" else "auto"
    plan = W.plan_folds([tuple(feats.shape)], warps, masks, feats.dtype,
                        windowed=True, place_impl=place)[0]
    assert plan.branch == branch
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    g = torch.randn(feats.shape, generator=gen, device=dev)

    def run():
        f = feats.clone().requires_grad_(True)
        out = W.apply_plan(f, warps, plan, image)
        out.backward(g)
        return out.detach(), f.grad

    before = dict(WF.LAUNCHES)
    out, grad = run()
    assert WF.LAUNCHES["warp_taps"] > before["warp_taps"]
    assert WF.LAUNCHES["warp_taps_t"] > before["warp_taps_t"]
    with W.banded_warps():
        mid = dict(WF.LAUNCHES)
        out_b, grad_b = run()
        assert WF.LAUNCHES["warp_taps"] == mid["warp_taps"]
        assert WF.LAUNCHES["warp_taps_t"] == mid["warp_taps_t"]
    assert (out - out_b).abs().max() <= 2.0 ** -18 * out_b.abs().max()
    # a max fold whose inputs moved by an ulp may pick another part at a
    # near-tie: the gradient's largest differences stay at a few elements
    diff = (grad - grad_b).abs()
    scale = grad_b.abs().max().item()
    assert (diff > 2.0 ** -16 * scale).float().mean() < 1e-3


@pytest.mark.cuda
def test_cuda_refuses_grad_and_counts():
    dev = _cuda()
    f, warps, y0, x0, s_y, s_x, init = _inputs("rotation", torch.bfloat16,
                                               c=16)
    f, warps, y0, x0 = (t.to(dev) for t in (f, warps, y0, x0))
    co = _coeffs(f, warps, y0, x0, init)
    before = dict(WF.LAUNCHES)
    with pytest.raises(RuntimeError, match="requires grad"):
        WF.warp_taps(f.float().requires_grad_(True), co, s_y, s_x)
    # a thread owns 16 bytes of channels
    with pytest.raises(ValueError, match="C % 8"):
        WF.warp_taps(f[..., :12].contiguous(), co, s_y, s_x)
    assert WF.LAUNCHES == before
    out = WF.warp_taps(f, co, s_y, s_x)
    torch.cuda.synchronize()
    assert WF.LAUNCHES["warp_taps"] == before["warp_taps"] + 1
    assert torch.equal(out.cpu(),
                       WF.warp_taps_reference(f.cpu(), co.cpu(), s_y, s_x))
