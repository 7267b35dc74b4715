"""The port's windowed fold with XLA-style placement (``place_impl='xla'``)
against the JAX package's.

``affine_transform_layer(place_impl='xla')`` of the port against JAX's
``warp_fold_matmul(..., place_impl='xla')`` under ``jax.vjp``, forward and
feature gradient, for fitting and sprawling masks, 'max' and 'avg' and a
static-empty part; the port's two placements against each other; the
placement choice threaded through ``GANConfig``, ``build_models`` and the
generator. Inputs come from numpy seeds and are fed to both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_transfer_tpu.ops import warp as jwarp
from pose_transfer_torch.models.networks import DeformableGenerator
from pose_transfer_torch.ops import warp as twarp
from pose_transfer_torch.ops import warp_fused as twf
from pose_transfer_torch.train.engine import (GANConfig, auto_windowed,
                                              build_models)

torch.set_num_threads(2)

N, H, W, C, T = 2, 64, 64, 16, 4
IMG = (H, W)


def _inputs(fit=True):
    """As tests/test_warp_place.py: two real parts, a sentinel (empty mask),
    and fitting or sprawling masks; a seeded cotangent."""
    rng = np.random.RandomState(0)
    f = rng.randn(N, H, W, C).astype(np.float32)
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
    g = rng.randn(N, H, W, C).astype(np.float32)
    return f, warps, masks, g


def _port(f, warps, masks, g, agg, se, place):
    """(out, df, scan fallbacks, _fold_windowed calls) of the port's
    layer."""
    ft = torch.tensor(f, requires_grad=True)
    calls = []
    real = twarp._fold_windowed

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    before = twarp.COUNTS["scan_fallback"]
    twarp._fold_windowed = counted
    try:
        out = twarp.affine_transform_layer(
            ft, torch.tensor(warps), torch.tensor(masks), IMG, "mask", agg,
            windowed=True, static_empty=se, place_impl=place)
        out.backward(torch.tensor(g))
    finally:
        twarp._fold_windowed = real
    return (out.detach().numpy(), ft.grad.numpy(),
            twarp.COUNTS["scan_fallback"] - before, len(calls))


@pytest.mark.parametrize("case", ["fit_max", "nofit_max", "fit_avg",
                                  "nofit_avg", "static_empty"])
def test_xla_placement_matches_jax(case):
    fit = not case.startswith("nofit")
    agg = "avg" if case.endswith("avg") else "max"
    se = (3,) if case == "static_empty" else ()
    f, warps, masks, g = _inputs(fit)
    # at the features' resolution the mask resize is the identity, so JAX's
    # fold takes the masks as they are
    out_j, vjp = jax.vjp(
        lambda x: jwarp.warp_fold_matmul(x, jnp.asarray(warps),
                                         jnp.asarray(masks), IMG, agg, True,
                                         se, "xla"), jnp.asarray(f))
    df_j = np.asarray(vjp(jnp.asarray(g))[0])
    out, df, fallbacks, calls = _port(f, warps, masks, g, agg, se, "xla")
    # f32 throughout; the two sides tile the same contractions differently
    # (ulp-level reassociation) and the backward's joint transposed warp
    # sums (part, window row) in another order than XLA's: the tolerance of
    # tests/test_warp_place.py:56-63
    np.testing.assert_allclose(out, np.asarray(out_j), atol=5e-5, rtol=0)
    np.testing.assert_allclose(df, df_j, atol=5e-5, rtol=0)
    assert np.abs(df_j).max() > 0.1
    # the windowed fold ran where every part fits, the scan where not
    assert (fallbacks, calls) == ((0, 1) if fit else (1, 0))


@pytest.mark.parametrize("fit", [True, False])
def test_xla_placement_matches_kernel_placement(fit):
    """The two placements of the port: same windows' content, the kernel's
    windows widened and aligned; ulp-level reassociation only, the
    tolerance of tests/test_warp_place.py:56-60."""
    f, warps, masks, g = _inputs(fit)
    out_x, df_x, _, _ = _port(f, warps, masks, g, "max", (), "xla")
    out_k, df_k, _, _ = _port(f, warps, masks, g, "max", (), "kernel")
    np.testing.assert_allclose(out_k, out_x, atol=5e-5, rtol=0)
    np.testing.assert_allclose(df_k, df_x, atol=5e-5, rtol=0)


@pytest.mark.parametrize("fit", [True, False])
def test_placements_agree_on_fits(fit):
    """One host sync per forward resolves both placements' flags, and the
    kernel's widened windows fit exactly where the (h/2, w/2) ones do."""
    _, warps, masks, _ = _inputs(fit)
    shapes = [(N, H, W, C), (N, H // 2, W // 2, C)]
    args = (shapes, torch.tensor(warps), torch.tensor(masks), torch.float32)
    kernel = twarp.plan_folds(*args, windowed=True, place_impl="kernel")
    xla = twarp.plan_folds(*args, windowed=True, place_impl="xla")
    assert [p.fits for p in kernel] == [p.fits for p in xla] == [fit, False]
    assert not kernel[0].xla and xla[0].xla
    # 32² is too small to window: no windows under either placement
    assert kernel[1].windows is None and xla[1].windows is None
    # 'avg' has no placement kernel: 'auto' takes the XLA-style placement
    avg = twarp.plan_folds(*args, warp_agg="avg", windowed=True)[0]
    assert avg.xla and avg.windows is not None
    with pytest.raises(ValueError, match="place_impl"):
        twarp.plan_folds(*args, windowed=True, place_impl="scatter")


def test_xla_placement_launches_no_kernel_and_emits_no_idx(monkeypatch):
    """The XLA-style placement never calls the placement or routing
    kernels' wrappers; its no-grad forward emits no argmax."""
    f, warps, masks, _ = (torch.tensor(a) for a in _inputs(True))
    for name in ("fold_place", "fold_route"):
        monkeypatch.setattr(twf, name, None)
    seen = []
    real = twarp._fold_windowed
    monkeypatch.setattr(twarp, "_fold_windowed",
                        lambda *a: seen.append(a[-1]) or real(*a))
    with torch.no_grad():
        twarp.affine_transform_layer(f, warps, masks, IMG, windowed=True,
                                     place_impl="xla")
    ft = f.clone().requires_grad_(True)
    twarp.affine_transform_layer(ft, warps, masks, IMG, windowed=True,
                                 place_impl="xla").sum().backward()
    assert seen == [False, True] and ft.grad.abs().max() > 0


def test_warp_place_config_and_windowed_rule():
    """GANConfig.warp_place reaches the generator; the auto rule is the JAX
    package's with its TPU read as a CUDA device: windowed when the kernel
    places, or at a batch of 16 or more."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = GANConfig(image_size=(64, 64), batch_size=8)
    assert cfg.warp_place == "auto"
    assert auto_windowed(cfg, cuda) and not auto_windowed(cfg, cpu)
    for kw in ({"warp_place": "xla"}, {"warp_agg": "avg"}):
        c8 = dataclasses.replace(cfg, **kw)
        assert not auto_windowed(c8, cuda)
        assert auto_windowed(dataclasses.replace(c8, batch_size=16), cuda)
    assert auto_windowed(dataclasses.replace(cfg, warp_place="kernel"), cuda)
    assert auto_windowed(dataclasses.replace(cfg, batch_size=16), cpu)
    assert not auto_windowed(
        dataclasses.replace(cfg, batch_size=32, warp_windowed=False), cuda)
    gen = build_models(dataclasses.replace(cfg, warp_place="xla",
                                           batch_size=16), device="cpu")
    assert gen.warp_place == "xla" and gen.warp_windowed
    with pytest.raises(ValueError, match="place_impl"):
        DeformableGenerator(18, (64, 64), (8, 16), (16, 3),
                            warp_place="scatter")


def test_generator_threads_warp_place(monkeypatch):
    """A narrow generator with warp_place='xla' folds its windowed stage
    through _fold_windowed, and agrees with the kernel placement."""
    rng = np.random.default_rng(0)
    _, warps, masks, _ = _inputs(True)
    inp = torch.tensor(rng.standard_normal((N, H, W, 3 + 36)),
                       dtype=torch.float32)
    outs = {}
    for place in ("xla", "kernel"):
        gen = DeformableGenerator(18, IMG, (8, 16), (16, 3),
                                  warp_windowed=True, warp_place=place)
        torch.manual_seed(0)
        for prm in gen.parameters():
            torch.nn.init.normal_(prm, std=0.2)
        seen = []
        real = twarp._fold_windowed
        monkeypatch.setattr(twarp, "_fold_windowed",
                            lambda *a: seen.append(1) or real(*a))
        with torch.no_grad():
            outs[place] = gen.eval()(inp, torch.tensor(warps),
                                     torch.tensor(masks))
        monkeypatch.setattr(twarp, "_fold_windowed", real)
        # 64² windows (xla only); the 32² stage takes the scan
        assert len(seen) == (place == "xla")
    # f32 tanh outputs; the fold's ulp-level reassociation carried through
    # the decoder
    torch.testing.assert_close(outs["xla"], outs["kernel"], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("static_empty", [(), (3,)])
def test_xla_placement_idx_matches_jax(static_empty):
    """The argmax of the XLA-style placement: ORIGINAL part indices, 0 for
    the body, -1 where the zero pass won; integers, compared exactly."""
    f, warps, masks, _ = _inputs(True)
    jm = jnp.asarray(masks)
    windows = jwarp._support_windows(jm, H // 2, W // 2)
    jo, ji = jwarp._fold_windowed(jnp.asarray(f), jnp.asarray(warps), jm,
                                  IMG, "max", windows, static_empty)
    y0, x0, _, _ = twarp._support_windows(torch.tensor(masks), H // 2,
                                          W // 2)
    to, ti = twarp._fold_windowed(torch.tensor(f), torch.tensor(warps),
                                  torch.tensor(masks), IMG, "max", (y0, x0),
                                  static_empty)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=5e-5, rtol=0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert set(np.unique(ti.numpy())) >= {-1, 0, 1, 2}
