"""The port's warp fold against the JAX package's.

``fold_place`` (plain PyTorch version on the CPU) against JAX's Pallas
``fold_place`` in interpret mode, bitwise; the fold paths and
``affine_transform_layer`` against JAX's ``warp_fold_matmul`` /
``affine_transform_layer`` with ``windowed=True, place_impl='kernel'`` (the
kernel-placed windowed fold, in interpret mode on the CPU), forward and
gradient (torch autograd against ``jax.vjp``). Inputs come from numpy seeds
and are fed to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_transfer_tpu.ops import warp as jwarp
from pose_transfer_tpu.ops import warp_fused as jwf
from pose_transfer_torch.ops import warp as twarp
from pose_transfer_torch.ops import warp_fused as twf

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32, np.uint32, torch.int32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16, torch.int16)}


def _bits_jax(x, dtype):
    return np.asarray(x).view(_DT[dtype][2])


def _bits_torch(x, dtype):
    return x.view(_DT[dtype][3]).numpy().view(_DT[dtype][2])


def _place_inputs(seed, n=2, h=64, w=64, c=16, parts=(1, 2, 3, 4), sy=32,
                  sx=48):
    """fold_place inputs with negatives in the body, zeros and fractions in
    the mask windows, exact ties across parts (part 2 repeats part 1's
    window) and exact ties with the body."""
    rng = np.random.default_rng(seed)
    p = len(parts)
    body = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wins = rng.standard_normal((n, p, sy, sx, c)).astype(np.float32)
    mwins = rng.choice([0.0, 0.25, 0.5, 1.0], size=(n, p, sy, sx)) \
        .astype(np.float32)
    offs = np.zeros((n, p, 3), np.int32)
    for i in range(n):
        for j in range(p):
            offs[i, j] = (rng.integers(0, h - sy + 1),
                          16 * rng.integers(0, (w - sx) // 16 + 1), parts[j])
        if p > 1:
            offs[i, 1, :2] = offs[i, 0, :2]
            y0, x0 = offs[i, 0, :2]
            # the body equals part 0's (unmasked) window on a patch
            body[i, y0:y0 + 4, x0:x0 + 4] = wins[i, 0, :4, :4]
            mwins[i, 0, :4, :4] = 1.0
    if p > 1:
        wins[:, 1] = wins[:, 0]
        mwins[:, 1] = mwins[:, 0]
    zero_nb = rng.random((n, h, w)) < 0.5
    return body, wins, mwins, zero_nb, offs


def _place_both(inputs, dtype, emit_idx):
    body, wins, mwins, zero_nb, offs = inputs
    jd, td = _DT[dtype][0], _DT[dtype][1]
    jo, ji = jwf.fold_place(
        jnp.asarray(body, jd), jnp.asarray(wins, jd), jnp.asarray(mwins, jd),
        jnp.asarray(zero_nb, jd), jnp.asarray(offs), interpret=True,
        emit_idx=emit_idx)
    to, ti = twf.fold_place(
        torch.tensor(body).to(td), torch.tensor(wins).to(td),
        torch.tensor(mwins).to(td), torch.tensor(zero_nb),
        torch.tensor(offs), emit_idx=emit_idx)
    return jo, ji, to, ti


@pytest.mark.parametrize("emit_idx", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_place_matches_jax_bitwise(dtype, emit_idx):
    jo, ji, to, ti = _place_both(_place_inputs(0), dtype, emit_idx)
    np.testing.assert_array_equal(_bits_torch(to, dtype), _bits_jax(jo, dtype))
    if emit_idx:
        assert ti.dtype == torch.int8
        idx = ti.numpy()
        np.testing.assert_array_equal(
            idx, np.asarray(ji.astype(jnp.float32)).astype(np.int8))
        # the ties resolved to the earlier part, the zero pass fired
        assert (idx == 1).any() and not (idx == 2).any()
        assert (idx == -1).any() and (idx == 0).any()
    else:
        assert ti is None and ji is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_place_static_empty_matches_jax(dtype):
    """pose_dim 16: only parts 6-9 are active, zero_nb is all ones."""
    inputs = list(_place_inputs(1, parts=(6, 7, 8, 9)))
    inputs[3] = np.ones_like(inputs[3])
    jo, ji, to, ti = _place_both(inputs, dtype, True)
    np.testing.assert_array_equal(_bits_torch(to, dtype), _bits_jax(jo, dtype))
    np.testing.assert_array_equal(
        ti.numpy(), np.asarray(ji.astype(jnp.float32)).astype(np.int8))
    assert set(np.unique(ti.numpy())) <= {-1, 0, 6, 8, 9}


def test_fold_place_cpu_takes_plain_version():
    """On CPU tensors the wrapper runs the plain version (no launch) and
    rejects inputs it cannot take."""
    body, wins, mwins, zero_nb, offs = (torch.tensor(a) for a in
                                        _place_inputs(2))
    before = twf.LAUNCHES["fold_place"]
    out, idx = twf.fold_place(body, wins, mwins, zero_nb, offs)
    ref, ref_idx = twf.fold_place_reference(body, wins, mwins, zero_nb, offs)
    assert torch.equal(out, ref) and torch.equal(idx, ref_idx)
    assert twf.LAUNCHES["fold_place"] == before
    with pytest.raises(TypeError):
        twf.fold_place(body, wins, mwins, zero_nb.float(), offs)
    with pytest.raises(ValueError):
        twf.fold_place(body, wins[:, :2], mwins, zero_nb, offs)


# --------------------------------------------------------------- the fold

N, H, W, C, T = 2, 64, 64, 16, 4
IMG = (H, W)


def _fold_inputs(fit=True, h=H):
    """As tests/test_warp_place.py: two real parts, a sentinel, and either
    fitting or sprawling masks."""
    rng = np.random.RandomState(0)
    f = rng.randn(N, h, h, C).astype(np.float32)
    warps = np.tile(np.array([1, 0, 0, 0, 1, 0, 0, 0], np.float32),
                    (N, T, 1))
    warps[:, 1] = [0.9, 0.1, 3.0, -0.15, 1.05, -2.0, 0, 0]
    warps[:, 2] = [1.2, -0.3, -5.0, 0.2, 0.8, 4.0, 0, 0]
    warps[:, 3] = [1, 0, 1000, 0, 1, 1000, 0, 0]   # sentinel
    masks = np.zeros((N, T, H, W), np.float32)
    masks[:, 0] = 1.0
    if fit:
        masks[:, 1, 5:30, 8:30] = 1.0
        masks[:, 2, 40:60, 33:60] = 1.0
    else:
        masks[:, 1] = 1.0                # sprawls: falls back to the scan
        masks[:, 2, 40:60, 33:60] = 1.0
    return f, warps, masks


def _jax_layer(f, warps, masks, static_empty=(), skip="mask", agg="max"):
    return np.asarray(jwarp.affine_transform_layer(
        jnp.asarray(f), jnp.asarray(warps), jnp.asarray(masks), IMG,
        skip, agg, "matmul", windowed=True, static_empty=static_empty,
        place_impl="kernel"))


def _torch_layer(f, warps, masks, static_empty=(), skip="mask", agg="max"):
    return twarp.affine_transform_layer(
        torch.tensor(f), torch.tensor(warps), torch.tensor(masks), IMG,
        skip, agg, windowed=True, static_empty=static_empty).numpy()


@pytest.mark.parametrize("case", ["windowed", "fallback", "static_empty",
                                  "not_windowable", "avg", "full", "none"])
def test_affine_transform_layer_matches_jax(case):
    """The kernel-placed windowed fold, the scan fallback of a sprawling
    mask, static-empty parts, a stage too small to window, the mean fold
    and the unmasked warp_skip modes ('full' has one transform)."""
    fit = case != "fallback"
    h = 32 if case == "not_windowable" else H
    f, warps, masks = _fold_inputs(fit, h=h)
    se = (3,) if case == "static_empty" else ()
    skip = case if case in ("full", "none") else "mask"
    agg = "avg" if case == "avg" else "max"
    if case == "full":
        warps, masks = warps[:, 1:2], masks[:, :1]
    before = twarp.COUNTS["scan_fallback"]
    out = _torch_layer(f, warps, masks, se, skip, agg)
    # the two sides tile the same f32 contractions differently: ulp-level
    # reassociation only, the tolerance of tests/test_warp_place.py
    np.testing.assert_allclose(
        out, _jax_layer(f, warps, masks, se, skip, agg), atol=5e-5)
    assert twarp.COUNTS["scan_fallback"] - before == (case == "fallback")


def _fold_grads(case):
    """(port gradient, JAX gradient, port scan fallbacks, fold_route calls)
    of <fold, cotangent> with respect to the features."""
    fit = case != "fallback"
    f, warps, masks = _fold_inputs(fit)
    se = (3,) if case == "static_empty" else ()
    agg = "avg" if case == "avg" else "max"
    g = np.random.RandomState(5).randn(*f.shape).astype(np.float32)

    def jfold(ff):
        return jwarp.affine_transform_layer(
            ff, jnp.asarray(warps), jnp.asarray(masks), IMG, "mask", agg,
            "matmul", windowed=True, static_empty=se, place_impl="kernel")
    _, vjp = jax.vjp(jfold, jnp.asarray(f))
    ref = np.asarray(vjp(jnp.asarray(g))[0])

    ft = torch.tensor(f, requires_grad=True)
    gt = torch.tensor(g)
    if case == "permuted":
        # the cotangent as the generator hands it over: an NHWC view of an
        # NCHW tensor
        gt = torch.tensor(np.ascontiguousarray(g.transpose(0, 3, 1, 2))) \
            .permute(0, 2, 3, 1)
        assert not gt.is_contiguous()
    before = twarp.COUNTS["scan_fallback"]
    routes = []
    real = twf.fold_route
    twf.fold_route = lambda *a: routes.append(a[0].shape) or real(*a)
    try:
        out = twarp.affine_transform_layer(
            ft, torch.tensor(warps), torch.tensor(masks), IMG, "mask", agg,
            windowed=True, static_empty=se)
        out.backward(gt)
    finally:
        twf.fold_route = real
    return (ft.grad.numpy(), ref, twarp.COUNTS["scan_fallback"] - before,
            len(routes))


@pytest.mark.parametrize("case", ["windowed", "fallback", "static_empty",
                                  "permuted", "avg"])
def test_fold_gradient_matches_jax(case):
    """The fold's gradient: the windowed branch (routed by fold_route), the
    scan fallback of a sprawling mask, static-empty parts, a permuted
    non-contiguous cotangent and the mean fold (scan only)."""
    got, ref, fallbacks, routes = _fold_grads(case)
    # f32; the joint transposed contraction sums (part, window row) in
    # another order than XLA's: the tolerance of tests/test_warp_place.py
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)
    assert np.abs(ref).max() > 0.1
    assert fallbacks == (case == "fallback")
    assert routes == (case not in ("fallback", "avg"))


def test_fold_forward_without_grad_emits_no_idx(monkeypatch):
    """Under no_grad (and for features that need no gradient) the fold runs
    its forward alone: fold_place without the argmax, no autograd node."""
    f, warps, masks = (torch.tensor(a) for a in _fold_inputs(True))
    seen = []
    real = twf.fold_place
    monkeypatch.setattr(twf, "fold_place",
                        lambda *a: seen.append(a[-1]) or real(*a))
    ft = f.clone().requires_grad_(True)
    with torch.no_grad():
        out = twarp.affine_transform_layer(ft, warps, masks, IMG,
                                           windowed=True)
    assert out.grad_fn is None
    out = twarp.affine_transform_layer(f, warps, masks, IMG, windowed=True)
    assert out.grad_fn is None
    out = twarp.affine_transform_layer(ft, warps, masks, IMG, windowed=True)
    assert isinstance(out.grad_fn, twarp.WarpFold._backward_cls)
    assert seen == [False, False, True]


def test_windowed_fold_equals_scan_fold():
    """Windowing is exact: the kernel-placed fold and the full scan agree."""
    f, warps, masks = (torch.tensor(a) for a in _fold_inputs(True))
    plan = twarp.plan_folds([tuple(f.shape)], warps, masks, f.dtype,
                            windowed=True)[0]
    assert plan.windows is not None and plan.fits
    out_w, _ = twarp._fold_windowed_place(f, warps, plan.masks_r, IMG,
                                          plan.windows, emit_idx=False)
    out_s, _ = twarp._fold_scan(f, warps, plan.masks_r, IMG, "max",
                                emit_idx=False)
    torch.testing.assert_close(out_w, out_s, atol=5e-5, rtol=0)


@pytest.mark.parametrize("static_empty", [(), (3,), (1, 2, 3)])
def test_fold_scan_idx_matches_jax(static_empty):
    """The scan's argmax: compacted positions with static_empty, -1 where
    the final max(acc, 0) won."""
    f, warps, masks = _fold_inputs(True)
    masks_r = jwarp.resize_bilinear(jnp.asarray(masks), IMG)
    jo, ji = jwarp._fold_scan(jnp.asarray(f), jnp.asarray(warps), masks_r,
                              IMG, "max", static_empty, emit_idx=True)
    to, ti = twarp._fold_scan(torch.tensor(f), torch.tensor(warps),
                              torch.tensor(np.asarray(masks_r)), IMG, "max",
                              static_empty, emit_idx=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=5e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if static_empty == (1, 2, 3):       # only the body: negatives → -1
        assert (ti.numpy() == -1).any()


def test_windowed_place_idx_matches_jax():
    """The windowed fold's argmax stores ORIGINAL part indices."""
    f, warps, masks = _fold_inputs(True)
    jf, jw = jnp.asarray(f), jnp.asarray(warps)
    masks_r = jwarp.resize_bilinear(jnp.asarray(masks), IMG)
    s_y, s_x = jwarp._kernel_window_sizes(H, W)
    y0, x0, _, _ = jwarp._support_windows(masks_r, s_y, s_x, jwf.X_ALIGN)
    jo, ji = jwarp._fold_windowed_place_impl(jf, jw, masks_r, IMG, (y0, x0),
                                             (), emit_idx=True)
    tm = torch.tensor(np.asarray(masks_r))
    plan = twarp.plan_folds([f.shape], torch.tensor(warps),
                            torch.tensor(masks), torch.float32,
                            windowed=True)[0]
    np.testing.assert_array_equal(plan.windows[0].numpy(), np.asarray(y0))
    np.testing.assert_array_equal(plan.windows[1].numpy(), np.asarray(x0))
    to, ti = twarp._fold_windowed_place(torch.tensor(f), torch.tensor(warps),
                                        tm, IMG, plan.windows,
                                        emit_idx=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=5e-5)
    np.testing.assert_array_equal(
        ti.numpy(), np.asarray(ji.astype(jnp.float32)).astype(np.int8))
    assert set(np.unique(ti.numpy())) >= {0, 1, 2}


@pytest.mark.parametrize("x_align", [1, 16])
def test_support_windows_match_jax(x_align):
    rng = np.random.RandomState(1)
    masks = np.zeros((4, 3, H, W), np.float32)
    for n in range(4):
        for t in range(3):
            y0, x0 = rng.randint(0, H - 8, 2)
            hh, ww = rng.randint(4, 40, 2)
            masks[n, t, y0:min(H, y0 + hh), x0:min(W, x0 + ww)] = 1.0
    masks[0, 2] = 0.0                     # one empty mask
    s_y, s_x = H // 2, H // 2 + 16
    ref = jwarp._support_windows(jnp.asarray(masks), s_y, s_x, x_align)
    got = twarp._support_windows(torch.tensor(masks), s_y, s_x, x_align)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_resize_bilinear_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.rand(2, 3, 64, 64).astype(np.float32)
    for hw in [(32, 32), (16, 16), (64, 64)]:
        np.testing.assert_allclose(
            twarp.resize_bilinear(torch.tensor(x), hw).numpy(),
            np.asarray(jwarp.resize_bilinear(jnp.asarray(x), hw)),
            atol=1e-6)


def test_shape_gates_match_jax():
    for h, w in [(256, 256), (128, 128), (64, 64), (32, 32), (224, 224),
                 (112, 112), (56, 56)]:
        assert twarp._windowable(h, w) == jwarp._windowable(h, w)
        assert twarp._kernel_window_sizes(h, w) \
            == jwarp._kernel_window_sizes(h, w)
    assert twarp._place_actives(10, (1, 2, 3, 4, 5)) == (6, 7, 8, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("emit_idx", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_place_kernel_matches_plain(dtype, emit_idx):
    """The CUDA kernel, bitwise against its plain version (on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    td = _DT[dtype][1]
    args = [torch.tensor(a) for a in _place_inputs(3)]
    args = [a.to(td) if a.is_floating_point() else a for a in args]
    ref, ref_idx = twf.fold_place_reference(*args, emit_idx=emit_idx)
    out, idx = twf.fold_place(*(a.cuda() for a in args), emit_idx=emit_idx)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu().view(_DT[dtype][3]),
                       ref.view(_DT[dtype][3]))
    if emit_idx:
        assert torch.equal(idx.cpu(), ref_idx)
