"""The port's fused warp fold (``warp_backend='pallas'``) against the JAX
package's.

The plain PyTorch versions (what the kernel wrappers run on CPU tensors)
against JAX's Pallas ``warp_fold_pallas`` in interpret mode, forward and
backward; the autograd Function; ``affine_transform_layer`` with
``backend='pallas'`` where the fused branch is taken and where it falls
back; a narrow generator with ``warp_backend='pallas'`` and one dropout-off
train step against the JAX package's, with the weights carried across by
``models.import_flax``. Inputs come from numpy seeds and go to both
packages.

Where the numbers differ, and why: in interpret mode XLA:CPU contracts the
TPU kernel's ``m·(i + ½) + (t − ½)`` into one fused multiply-add (measured);
the port computes every product and sum rounded, as the kernel's source
reads and as the CUDA kernels do. Positions then differ by an ulp, and so do
the f32 ramp weights (≤ 2^-24·|pos|, |pos| ≤ 2^8 here: ≤ 1.5e-5 per weight,
times |f| ≤ 5). With the contraction reproduced, bf16 is bitwise equal
forward and backward (``test_plain_matches_jax_bitwise_with_contraction``);
f32 keeps one rounding of difference, since XLA sums the two f32 products
in f32 and the port rounds their exact f64 sum once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_transfer_tpu.ops import warp as jwarp
from pose_transfer_tpu.ops import warp_pallas as jwp
from pose_transfer_torch.models import networks
from pose_transfer_torch.models.import_flax import (
    discriminator_state_dict_from_flax, generator_state_dict_from_flax)
from pose_transfer_torch.ops import warp as twarp
from pose_transfer_torch.ops import warp_fused as twf
from pose_transfer_torch.ops import warp_pallas as twp
from pose_transfer_torch.train import engine

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32, np.uint32, torch.int32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16, torch.int16)}
SHAPES = {"small": (2, 16, 16, 8, 3), "wide": (1, 16, 128, 8, 10)}
# f32, port against XLA:CPU's contracted positions: ≤ 1.5e-5 per weight
# times |f| ≤ 5 and two taps per pass (module docstring)
F32_ATOL = 1e-4
# bf16: a weight within an ulp of a bf16 rounding boundary rounds the other
# way; measured 3-37 elements of 4096-16384 (≤ 0.9 %), each by one ulp of the
# value (2^-8 relative; after the per-part accumulation at most two), or,
# where two taps nearly cancel, by less than 2^-16 of the map's largest
# value
BF16_SHARE, BF16_ULPS, BF16_CANCEL = 0.02, 2, 2.0 ** -16


def _bits(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.view(_DT[dtype][3]).numpy().view(_DT[dtype][2])
    return np.asarray(x).view(_DT[dtype][2])


def _inputs(shape, seed=0):
    """Features with negatives; transforms: identity (single taps), shear
    and scale, the translation-by-1000 sentinel, random affines, and an
    exact tie (part 4 repeats part 3's transform and mask); masks with
    zeros and fractions."""
    n, h, w, c, t = shape
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, h, w, c)).astype(np.float32)
    warps = np.tile(np.asarray([1, 0, 0, 0, 1, 0, 0, 0], np.float32),
                    (n, t, 1))
    if t > 1:
        warps[:, 1] = [0.9, 0.1, 2.0, -0.1, 1.1, -1.0, 0, 0]
    if t > 2:
        warps[:, 2] = [1.0, 0.0, 1000.0, 0.0, 1.0, 1000.0, 0, 0]
    for k in range(3, t):
        warps[:, k, :6] = [rng.uniform(0.5, 1.5), rng.uniform(-0.3, 0.3),
                           rng.uniform(-5, 5), rng.uniform(-0.3, 0.3),
                           rng.uniform(0.5, 1.5), rng.uniform(-5, 5)]
    masks = rng.choice([0.0, 0.25, 0.5, 1.0], size=(n, t, h, w)) \
        .astype(np.float32)
    if t > 4:
        warps[:, 4], masks[:, 4] = warps[:, 3], masks[:, 3]
    return f, warps, masks


def _torch_args(inputs, dtype):
    f, warps, masks = inputs
    td = _DT[dtype][1]
    return (torch.tensor(f).to(td), torch.tensor(warps),
            torch.tensor(masks).to(td))


def _jax_fold(inputs, dtype, g):
    """JAX's forward (out, int32 idx) and gradient, through the rule pair
    of ``warp_fold_pallas``'s custom VJP (``_fwd``, ``_bwd``: what
    ``jax.vjp`` runs), jitted."""
    f, warps, masks = inputs
    jd = _DT[dtype][0]
    out, res = jax.jit(lambda ff, w, m: jwp._fwd(ff, w, m, True))(
        jnp.asarray(f, jd), jnp.asarray(warps), jnp.asarray(masks, jd))
    df = jax.jit(lambda r, gg: jwp._bwd(True, r, gg)[0])(
        res, jnp.asarray(g, jd))
    return out, np.asarray(res[2]), df


@functools.lru_cache(maxsize=None)
def _case(name, dtype):
    """Both packages' forward and backward on one input set (cached: the
    interpret-mode runs are the slow part)."""
    inputs = _inputs(SHAPES[name])
    g = np.random.default_rng(9).standard_normal(inputs[0].shape) \
        .astype(np.float32)
    jo, ji, jdf = _jax_fold(inputs, dtype, g)
    args = _torch_args(inputs, dtype)
    to, ti = twp.warp_fold_pallas_reference(*args)
    tg = torch.tensor(g).to(_DT[dtype][1])
    tdf = twp.warp_fold_pallas_bwd_reference(tg, args[1], args[2], ti)
    return (jo, ji, jdf), (to, ti, tdf), (args, tg)


def _assert_close(got, want, dtype, what):
    """F32_ATOL in f32; in bf16 at most BF16_SHARE of the elements differ,
    each by at most BF16_ULPS ulps of the larger magnitude or BF16_CANCEL
    of the map's largest value."""
    a = got.float().numpy()
    b = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=0, err_msg=what)
        return
    diff = np.abs(a - b)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), np.abs(b))
                                   + 1e-30)) - 7)
    assert (diff > 0).mean() <= BF16_SHARE, (what, (diff > 0).sum())
    ok = (diff <= BF16_ULPS * ulp) | (diff <= BF16_CANCEL * np.abs(b).max())
    assert ok.all(), (what, diff[~ok].max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["small", "wide"])
def test_plain_forward_matches_jax(name, dtype):
    (jo, ji, _), (to, ti, _), _ = _case(name, dtype)
    assert to.dtype == _DT[dtype][1] and ti.dtype == torch.int8
    _assert_close(to, jo, dtype, "out")
    np.testing.assert_array_equal(ti.numpy(), ji)
    idx = ti.numpy()
    # the sentinel never wins over a real part, the tie goes to part 3
    assert (idx == 1).any() and not (idx == 2).all()
    if SHAPES[name][4] > 4:
        assert (idx == 3).any() and not (idx == 4).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["small", "wide"])
def test_plain_backward_matches_jax_vjp(name, dtype):
    (_, ji, jdf), (_, ti, tdf), _ = _case(name, dtype)
    np.testing.assert_array_equal(ti.numpy(), ji)   # the same routing
    assert tdf.dtype == _DT[dtype][1]
    _assert_close(tdf, jdf, dtype, "df")
    assert np.abs(np.asarray(jdf.astype(jnp.float32))).max() > 1.0


def _contracted_positions(coef, n, offset):
    """XLA:CPU's fused multiply-add for ``coef·(i + ½) + offset``: the f64
    product is exact, the sum rounds (once more to f32)."""
    i = torch.arange(n, dtype=torch.float64) + 0.5
    return (coef.double()[:, None] * i + offset.double()[:, None]).float()


@pytest.mark.parametrize("name", ["small", "wide"])
def test_plain_matches_jax_bitwise_with_contraction(name, monkeypatch):
    """With XLA:CPU's contraction reproduced, the plain versions are bit
    for bit JAX's in bf16 (forward out and idx, backward): every other
    rounding is in the same place."""
    (jo, ji, jdf), _, (args, tg) = _case(name, "bfloat16")
    monkeypatch.setattr(twp, "_positions", _contracted_positions)
    to, ti = twp.warp_fold_pallas_reference(*args)
    tdf = twp.warp_fold_pallas_bwd_reference(tg, args[1], args[2], ti)
    np.testing.assert_array_equal(_bits(to, "bfloat16"),
                                  _bits(jo, "bfloat16"))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(_bits(tdf, "bfloat16"),
                                  _bits(jdf, "bfloat16"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_gradient_is_the_plain_backward(dtype):
    """``WarpFoldPallas``: the forward with the argmax, the gradient of the
    features is the plain backward at that argmax, warps and masks get
    none; on CPU tensors nothing is launched."""
    f, warps, masks = _torch_args(_inputs(SHAPES["small"], 1), dtype)
    g = torch.tensor(np.random.default_rng(2).standard_normal(f.shape)
                     .astype(np.float32)).to(f.dtype)
    before = dict(twp.LAUNCHES)
    fr = f.clone().requires_grad_(True)
    wr = warps.clone().requires_grad_(True)
    out = twp.WarpFoldPallas.apply(fr, wr, masks)
    assert isinstance(out.grad_fn, twp.WarpFoldPallas._backward_cls)
    out.backward(g)
    ref, idx = twp.warp_fold_pallas_reference(f, warps, masks)
    assert torch.equal(out.detach(), ref)
    assert torch.equal(fr.grad, twp.warp_fold_pallas_bwd_reference(
        g, warps, masks, idx))
    assert wr.grad is None
    assert twp.LAUNCHES == before


def test_plain_backward_is_autograd_of_plain_forward():
    """The plain backward is the transpose of the plain forward: autograd
    through ``warp_fold_pallas_reference`` (f32) routes by the same argmax
    and sums the same exact f64 products per pass, in another order across
    the parts: within 1e-6 of the largest entry."""
    f, warps, masks = _torch_args(_inputs((2, 16, 128, 8, 10), 6),
                                  "float32")
    g = torch.tensor(np.random.default_rng(7).standard_normal(f.shape)
                     .astype(np.float32))
    fr = f.clone().requires_grad_(True)
    out, idx = twp.warp_fold_pallas_reference(fr, warps, masks)
    out.backward(g)
    want = twp.warp_fold_pallas_bwd_reference(g, warps, masks, idx)
    scale = want.abs().max().item()
    assert scale > 1.0
    assert (fr.grad - want).abs().max().item() <= 1e-6 * scale


def test_wrappers_check_their_inputs():
    f, warps, masks = _torch_args(_inputs(SHAPES["small"], 3), "float32")
    out, idx = twp.warp_fold(f, warps, masks, emit_idx=False)
    assert idx is None and torch.equal(
        out, twp.warp_fold_pallas_reference(f, warps, masks, False)[0])
    with pytest.raises(TypeError):
        twp.warp_fold(f, warps.double(), masks)
    with pytest.raises(TypeError):
        twp.warp_fold(f, warps, masks.bfloat16())
    with pytest.raises(ValueError):
        twp.warp_fold(f, warps[:, :2], masks)
    _, idx = twp.warp_fold(f, warps, masks)
    with pytest.raises(ValueError):
        twp.warp_fold_bwd(f, warps, masks, idx.int())
    with pytest.raises(RuntimeError, match="requires grad"):
        twp.warp_fold(f.requires_grad_(True), warps, masks)
    with pytest.raises(RuntimeError, match="requires grad"):
        twp.warp_fold_bwd(f, warps, masks, idx)


def test_supported_matches_jax():
    sizes = (8, 16, 28, 32, 56, 64, 112, 120, 128, 224, 256, 384)
    for h in sizes:
        for w in sizes:
            assert twp.supported(h, w) == jwp.supported(h, w), (h, w)


# ------------------------------------------------------------- the layer

IMG = (32, 256)


def _layer_inputs(case):
    w = 64 if case == "narrow" else 128
    t = 1 if case == "full" else 10
    f, warps, _ = _inputs((2, 16, w, 8, t), 4)
    rng = np.random.default_rng(5)
    masks = (rng.random((2, t, *IMG)) > 0.3).astype(np.float32)
    img = (IMG[0], 2 * w)
    return f, warps, masks, img


@pytest.fixture
def jax_interpret(monkeypatch):
    """JAX's Pallas fold in interpret mode (as tests/test_warp_pallas.py
    runs it on the CPU), counting its calls."""
    calls = []
    orig = jwp.warp_fold_pallas

    def interpreted(f, w, m, interpret=False):
        calls.append(f.shape)
        return orig(f, w, m, True)
    monkeypatch.setattr(jwp, "warp_fold_pallas", interpreted)
    return calls


@pytest.mark.parametrize("case", ["pallas", "narrow", "avg", "full"])
def test_layer_matches_jax(case, jax_interpret):
    """The fused branch at W = 128; W = 64 and the mean fold fall back to
    the matmul branch on both sides; warp_skip='full' folds one transform
    under an all-ones mask. Forward and feature gradient."""
    f, warps, masks, img = _layer_inputs(case)
    skip = "full" if case == "full" else "mask"
    agg = "avg" if case == "avg" else "max"
    g = np.random.default_rng(6).standard_normal(f.shape).astype(np.float32)

    def jlayer(ff):
        return jwarp.affine_transform_layer(
            ff, jnp.asarray(warps), jnp.asarray(masks), img, skip, agg,
            "pallas")
    ref, vjp = jax.vjp(jlayer, jnp.asarray(f))
    ref_df = vjp(jnp.asarray(g))[0]
    took_pallas = bool(jax_interpret)

    plan = twarp.plan_folds([f.shape], torch.tensor(warps),
                            torch.tensor(masks), torch.float32, skip, agg,
                            backend="pallas")[0]
    assert plan.pallas == took_pallas == (case in ("pallas", "full"))
    assert plan.windows is None
    ft = torch.tensor(f, requires_grad=True)
    out = twarp.affine_transform_layer(
        ft, torch.tensor(warps), torch.tensor(masks), img, skip, agg,
        backend="pallas")
    out.backward(torch.tensor(g))
    # the matmul fallback: the tolerance of tests/test_torch_fold.py
    atol = F32_ATOL if took_pallas else 5e-5
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(ref_df),
                               atol=atol, rtol=0)
    assert np.abs(np.asarray(ref_df)).max() > 0.5


# ------------------------------------------------- generator and train step

SIZE = (128, 128)
N = 2
ENC = (16, 16, 32, 32, 32, 32)
DEC = (32, 32, 32, 16, 16, 3)
IN_CH = 3 + 2 * 18 + 3          # discriminator input channels


def _jgen(dtype=jnp.float32):
    from pose_transfer_tpu.models import DeformableGenerator as JGen
    return JGen(pose_dim=18, image_size=SIZE, nfilters_enc=ENC,
                nfilters_dec=DEC, warp_backend="pallas", warp_windowed=True,
                warp_place="kernel", dtype=dtype)


def _tgen(params, dtype=torch.float32):
    gen = networks.DeformableGenerator(18, SIZE, ENC, DEC,
                                       warp_windowed=True,
                                       warp_backend="pallas", dtype=dtype)
    gen.load_state_dict(generator_state_dict_from_flax(params))
    return gen


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_data():
    """JAX's synthetic batches and batch preparer. The JAX package's data,
    models and train modules are imported where they are used: they need
    ``imageio`` and ``flax``, which a machine that runs only this file's
    ``cuda`` tests may lack."""
    from pose_transfer_tpu.data import synthetic
    from pose_transfer_tpu.data.device import make_batch_preparer
    return synthetic, make_batch_preparer


@pytest.fixture(scope="module")
def gen_setup():
    jsyn, jprep = _jax_data()
    batch = jsyn.synthetic_compact_batch(np.random.default_rng(0), N, SIZE,
                                         18)
    prep = jprep(image_size=SIZE, pose_dim=18)(batch)
    # parameters from the matmul generator: the same tree
    from pose_transfer_tpu.models import DeformableGenerator as JGen
    plain = JGen(pose_dim=18, image_size=SIZE, nfilters_enc=ENC,
                 nfilters_dec=DEC)
    params = jax.jit(functools.partial(plain.init, train=False))(
        {"params": jax.random.PRNGKey(0)}, prep["input"], prep["warps"],
        prep["masks"])
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * (len(jax.tree_util.keystr(path)) % 5)
        if x.ndim == 0 else x, params)
    return batch, prep, _np(params)


def _count_kernels(mp):
    """Record the fold wrappers' calls: (name, H, emit_idx)."""
    calls = []
    for mod, name in ((twp, "warp_fold"), (twp, "warp_fold_bwd"),
                      (twf, "fold_place"), (twf, "fold_route")):
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _name=name, **k):
            emit = a[-1] if isinstance(a[-1], bool) else k.get("emit_idx")
            calls.append((_name, a[0].shape[1], emit))
            return _real(*a, **k)
        mp.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generator_matches_jax(gen_setup, dtype, jax_interpret):
    """The 128² stage takes the fused fold on both sides, the 64² stage the
    kernel-placed windowed fold (64 is not a multiple of 128), 32² and 16²
    the full scan. f32: the fold's weights differ by an ulp (module
    docstring) and convolutions are summed in other orders, ~1e-6 relative
    per layer: 2e-4. bf16: the tolerance of tests/test_torch_model.py
    (single-ulp roundings at other places, carried by the decoder)."""
    _, prep, params = gen_setup
    jd, td = _DT[dtype][0], _DT[dtype][1]
    fwd = jax.jit(lambda p, i, w, m: _jgen(jd).apply(p, i, w, m,
                                                     train=False))
    ref = np.asarray(fwd(params, *(prep[k].astype(jd) for k in
                                   ("input", "warps", "masks")))
                     .astype(jnp.float32))
    assert [s[1] for s in jax_interpret] == [128]
    with pytest.MonkeyPatch.context() as mp:
        calls = _count_kernels(mp)
        with torch.inference_mode():
            got = _tgen(params, td).eval()(
                *(torch.tensor(np.asarray(prep[k])).to(td)
                  for k in ("input", "warps", "masks"))).float().numpy()
    assert calls == [("warp_fold", 128, False), ("fold_place", 64, False)]
    diff = np.abs(got - ref)
    if dtype == "float32":
        assert diff.max() <= 2e-4, diff.max()
    else:
        assert diff.mean() <= 5e-3 and diff.max() <= 0.08, \
            (diff.mean(), diff.max())
    assert np.abs(got).max() > 0.05


@pytest.fixture(scope="module")
def step_case(gen_setup):
    """One dropout-off train step on both sides from the same parameters
    (as tests/test_torch_train.py composes JAX's step from its pieces)."""
    from pose_transfer_tpu.models import Discriminator as JDisc
    from pose_transfer_tpu.models.import_torch import import_discriminator
    from pose_transfer_tpu.train import GANConfig as JConfig
    from pose_transfer_tpu.train import engine as jengine
    from pose_transfer_tpu.train import losses as jlosses
    jsyn, jprep = _jax_data()
    _, _, gen_params = gen_setup
    rng = np.random.default_rng(1)
    fake, real, gen_b = (jsyn.synthetic_compact_batch(rng, N, SIZE, 18)
                         for _ in range(3))
    jdisc = JDisc()
    disc_params = _np(jdisc.init({"params": jax.random.PRNGKey(1)},
                                 jnp.zeros((1, *SIZE, IN_CH)), train=False))

    cfg = engine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                           warp_windowed=True, warp_backend="pallas")
    gen = _tgen(gen_params)
    disc = networks.Discriminator(IN_CH)
    disc.load_state_dict(discriminator_state_dict_from_flax(disc_params))
    rng_t = torch.Generator().manual_seed(0)
    state = engine.TrainState(
        gen=gen, disc=disc,
        gen_opt=engine.make_optimizer(cfg, gen.parameters()),
        disc_opt=engine.make_optimizer(cfg, disc.parameters()), rng=rng_t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(networks.ChannelDropout, "forward", lambda self, x: x)
        calls = _count_kernels(mp)
        metrics, out_gen = engine.make_train_step(cfg, state)(
            {k: v[None] for k, v in fake.items()},
            {k: v[None] for k, v in real.items()}, gen_b)
    port = {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "out_gen": out_gen.numpy(), "calls": calls,
            "gen_grads": {k: p.grad.clone()
                          for k, p in gen.named_parameters()}}

    jcfg = JConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                   warp_backend="pallas", warp_windowed=True,
                   warp_place="kernel")
    jgen = _jgen()
    prep = jprep(image_size=SIZE, pose_dim=18)
    orig = jwp.warp_fold_pallas
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwp, "warp_fold_pallas",
                   lambda f, w, m, interpret=False: orig(f, w, m, True))

        def disc_loss(dp, gp, fk, rl):
            out = jax.lax.stop_gradient(
                jengine.gen_apply(jgen, gp, fk, jcfg, train=False)[0])
            both = jnp.concatenate(
                [jengine.disc_input(rl["input"], rl["target"], jcfg),
                 jengine.disc_input(fk["input"], out, jcfg)], axis=0)
            res = jdisc.apply(dp, both, train=True)
            t, f = jlosses.disc_adversarial_loss(res[:N], res[N:], 1.0, N)
            return t + f, (t, f)

        def gen_loss(gp, dp, b):
            out = jengine.gen_apply(jgen, gp, b, jcfg, train=False)[0]
            d_out = jdisc.apply(dp, jengine.disc_input(b["input"], out,
                                                       jcfg), train=True)
            ad = jlosses.gen_adversarial_loss(d_out, 1.0, N)
            ll = jlosses.l1_loss(out, b["target"]) * 100.0
            return ad + ll, (ll, ad, out)

        d_total, (d_true, d_fake) = jax.jit(disc_loss)(
            disc_params, gen_params, prep(fake), prep(real))
        # the generator phase against the port's updated discriminator
        disc_new = _np(import_discriminator(
            {k: v.detach().numpy() for k, v in disc.state_dict().items()}))
        (g_total, (ll, ad, out)), g_grads = jax.jit(jax.value_and_grad(
            gen_loss, has_aux=True))(gen_params, disc_new, prep(gen_b))
    ref = {"metrics": {"gen": np.array([g_total, ll, ad], np.float32),
                       "disc": np.array([d_total, d_true, d_fake],
                                        np.float32)},
           "out_gen": np.asarray(out),
           "gen_grads": generator_state_dict_from_flax(_np(g_grads))}
    return port, ref


def test_train_step_matches_jax(step_case):
    """Losses, the generator output and the generator's gradients (through
    both folds' backward). f32; the tolerances of tests/test_torch_train.py
    (|got − want| ≤ 1e-4·|want| + 1e-4·max|want|), losses 1e-5 relative,
    the output 2e-4 (test_generator_matches_jax). The fused fold's f32
    sums differ by an ulp (module docstring), so where two parts' masked
    warps tie within it the argmax crowns the other part and routes that
    pixel's cotangent elsewhere: the first conv of ``encoder_app``, which
    the 128² skip feeds, had 18 of 3024 entries beyond the tolerance, all
    within 2.2e-4 of its largest. So all but 1 % of each tensor's entries
    must meet the tolerance, and every entry 5e-4 of the largest. (From
    weights the port draws itself the two packages differ by more, through
    JAX's CPU norm sums: test_generator_gradient_gap_is_jax_cpu_norm_sums.)"""
    port, ref = step_case
    for phase in ("gen", "disc"):
        np.testing.assert_allclose(port["metrics"][phase],
                                   ref["metrics"][phase], rtol=1e-5,
                                   err_msg=phase)
    np.testing.assert_allclose(port["out_gen"], ref["out_gen"], atol=2e-4)
    got, want = port["gen_grads"], ref["gen_grads"]
    assert set(got) == set(want)
    for k in want:
        w, g = want[k].numpy(), got[k].numpy()
        scale = np.abs(w).max()
        diff = np.abs(g - w)
        over = diff > 1e-4 * np.abs(w) + 1e-4 * scale
        assert over.mean() <= 0.01, (k, over.sum())
        assert diff.max() <= 5e-4 * scale, (k, diff.max() / scale)
        assert scale > 0, k


def test_train_step_kernel_calls(step_case):
    """Disc phase: the fused fold without the argmax at 128², fold_place
    without it at 64²; gen phase: both with the argmax; its backward:
    fold_route at 64² and the fused backward at 128²."""
    port, _ = step_case
    assert port["calls"] == [
        ("warp_fold", 128, False), ("fold_place", 64, False),
        ("warp_fold", 128, True), ("fold_place", 64, True),
        ("fold_route", 64, None), ("warp_fold_bwd", 128, None)]


def _rel_diffs(got, want):
    """Per tensor: max |got − want| over max |want|."""
    return {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
            for k in want}


def _norm_f64(x, weight, bias, eps=1e-3):
    """The port's volume instance norm computed in x's dtype (its own
    computes in f32 whatever the dtype), for a true f64 run."""
    dims = tuple(range(1, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def _jnorm_blocked(x, weight, bias, eps=1e-3):
    """JAX's volume instance norm with its two stats, E[x] and E[x²],
    summed in 16 blocks and then over the blocks, in f32: the same formula
    as ``pose_transfer_tpu/ops/norm.py``, whose one f32 reduction per stat
    XLA:CPU sums in one sequence."""
    x32 = x.astype(jnp.float32)

    def stat(v):
        v = v.reshape(x.shape[0], 16, -1)
        return jnp.mean(jnp.mean(v, axis=2), axis=1)[:, None, None, None]
    mean, msq = stat(x32), stat(jnp.square(x32))
    var = jnp.maximum(msq - jnp.square(mean), 0.0)
    y = (x32 - mean) * jax.lax.rsqrt(var + eps)
    return (y * weight + bias).astype(x.dtype)


@pytest.fixture(scope="module")
def glorot_case(gen_setup):
    """Gradients of the 128² generator's L1 loss from weights the port
    draws itself (``networks.init_weights``, Glorot, seed 0), on the
    default backend's full-scan fold: the port in f32, in f64 (its norm too)
    and in f64 from weights scaled by 1 + ε·u (u uniform in ±1, ε = 2^-24
    and 1e-5); JAX in f32 with its own norm and with ``_jnorm_blocked``."""
    from pose_transfer_tpu.models import DeformableGenerator as JGen
    from pose_transfer_tpu.models import networks as jnet
    from pose_transfer_tpu.models.import_torch import import_generator
    _, prep, _ = gen_setup
    gen = networks.DeformableGenerator(18, SIZE, ENC, DEC)
    networks.init_weights(gen, torch.Generator().manual_seed(0))
    sd = {k: v.detach().clone() for k, v in gen.state_dict().items()}
    args = {k: torch.tensor(np.asarray(prep[k]))
            for k in ("input", "warps", "masks", "target")}

    def port(dtype, eps=0.0):
        g = networks.DeformableGenerator(18, SIZE, ENC, DEC, dtype=dtype)
        g.load_state_dict(sd)
        g = g.to(dtype).eval()
        if eps:
            draw = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in g.parameters():
                    u = torch.rand(p.shape, generator=draw, dtype=dtype)
                    p.mul_(1 + eps * (2 * u - 1))
        out = g(*(args[k].to(dtype) for k in ("input", "warps", "masks")))
        (100 * (out - args["target"].to(dtype)).abs().mean()).backward()
        return {k: p.grad.double().numpy() for k, p in g.named_parameters()}

    def jax_side():
        params = import_generator({k: v.numpy() for k, v in sd.items()},
                                  len(ENC), len(DEC))
        jg = JGen(pose_dim=18, image_size=SIZE, nfilters_enc=ENC,
                  nfilters_dec=DEC)

        def loss(p):
            out = jg.apply(p, prep["input"], prep["warps"], prep["masks"],
                           train=False)
            return 100 * jnp.abs(out - prep["target"]).mean()
        grads = jax.jit(jax.grad(loss))(params)
        return {k: v.double().numpy() for k, v in
                generator_state_dict_from_flax(_np(grads)).items()}

    res = {"f32": port(torch.float32), "jax": jax_side()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(networks, "volume_instance_norm", _norm_f64)
        res["f64"] = port(torch.float64)
        res["f64_ulp"] = port(torch.float64, 2.0 ** -24)
        res["f64_1e-5"] = port(torch.float64, 1e-5)
        mp.setattr(jnet, "volume_instance_norm", _jnorm_blocked)
        res["jax_blocked"] = jax_side()
    return res


def test_generator_gradient_gap_is_jax_cpu_norm_sums(glorot_case):
    """From weights the port draws itself, the port's f32 generator
    gradients at 128² differ from JAX's by more than 1e-3 of some tensor's
    largest entry (the deep, small stages). The port's are the accurate
    ones: within 1e-4 of its own f64 run. JAX's XLA:CPU run sums each
    volume-norm stat in f32 in one sequence over up to 2^18 elements; with
    the same stats summed in blocks, JAX agrees with the port within 1e-4.
    The gradient is discontinuous (ReLU kinks, the fold's argmax): weights
    moved by 1e-5 of their value move it by more than 1e-3, by an f32 ulp
    by less than 1e-4; so the stats' error decides which side of a kink a
    value falls on. The train-step tests above use flax-initialised
    weights, whose gradients stay clear of such kinks."""
    r = glorot_case
    assert max(_rel_diffs(r["f32"], r["f64"]).values()) <= 1e-4
    assert max(_rel_diffs(r["jax"], r["f32"]).values()) > 1e-3
    assert max(_rel_diffs(r["jax_blocked"], r["f32"]).values()) <= 1e-4
    assert max(_rel_diffs(r["f64_ulp"], r["f64"]).values()) <= 1e-4
    assert max(_rel_diffs(r["f64_1e-5"], r["f64"]).values()) > 1e-3


# ------------------------------------------------------ kernels on the card

def _fwd_equal(out, idx, ref, ref_idx, dtype):
    """The CUDA forward against its plain version: ``out`` bit for bit once
    −0 is mapped to +0, ``idx`` bit for bit. The kernel folds zm = +0 where
    a part's mask is 0 (it skips the taps); the plain version rounds z·0 to
    z's signed zero. The compare is a strict f32 '>' and +0 == −0, so only
    the sign of a zero output can differ, never the argmax."""
    assert torch.equal((out.cpu() + 0.0).view(_DT[dtype][3]),
                       (ref + 0.0).view(_DT[dtype][3]))
    if ref_idx is not None:
        assert torch.equal(idx.cpu(), ref_idx)


def _bwd_within(df, ref, dtype):
    """The CUDA backward against its plain version: both sum exact f64
    products, in other orders, so a rounding may flip; f32 within 1e-6 of
    the largest element, bf16 within two ulps."""
    diff = (df.cpu().float() - ref.float()).abs()
    if dtype == "float32":
        assert diff.max() <= 1e-6 * ref.abs().max()
    else:
        assert (diff <= 2 * 2.0 ** (torch.floor(torch.log2(
            ref.float().abs() + 1e-30)) - 7)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("emit_idx", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_fold_kernel_matches_plain(dtype, emit_idx):
    """The CUDA forward against its plain version (on the card), bitwise
    apart from the sign of zeros (``_fwd_equal``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _torch_args(_inputs((2, 16, 128, 16, 10), 7), dtype)
    ref, ref_idx = twp.warp_fold_pallas_reference(*args, emit_idx=emit_idx)
    out, idx = twp.warp_fold(*(a.cuda() for a in args), emit_idx=emit_idx)
    torch.cuda.synchronize()
    _fwd_equal(out, idx, ref, ref_idx, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_fold_bwd_kernel_matches_plain(dtype):
    """The CUDA backward against its plain version (on the card), within
    the tolerance of ``_bwd_within``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    f, warps, masks = _torch_args(_inputs((2, 16, 128, 16, 10), 8), dtype)
    _, idx = twp.warp_fold_pallas_reference(f, warps, masks)
    g = torch.tensor(np.random.default_rng(3).standard_normal(f.shape)
                     .astype(np.float32)).to(f.dtype)
    ref = twp.warp_fold_pallas_bwd_reference(g, warps, masks, idx)
    df = twp.warp_fold_bwd(g.cuda(), warps.cuda(), masks.cuda(),
                           idx.cuda())
    _bwd_within(df, ref, dtype)


def _tile_masks(shape, seed):
    """Masks that are 0 over whole kernel tiles (and over some single
    pixels), so that both kernels' skips run: part 0 all ones, parts 1-9
    nonzero on a random block of rows and columns each (part 5 all ones);
    transforms with scales 0.3-3 (a steep m11 takes warp_fold_bwd's
    multi-pass staging), shears, the sentinel and a near-zero slope."""
    f, warps, masks = _inputs(shape, seed)
    n, t, h, w = masks.shape
    rng = np.random.default_rng(seed + 1)
    keep = np.zeros_like(masks)
    keep[:, 0] = keep[:, 5] = 1.0
    for i in range(n):
        for k in range(1, t):
            y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 16)
            keep[i, k, y0:y0 + rng.integers(2, 9),
                 x0:x0 + rng.integers(4, 40)] = 1.0
    warps[:, 5, 4] = 0.2           # steep: source rows 5x as dense
    warps[:, 6, 0] = 3.0           # spread columns
    warps[:, 7, 4] = 1e-4          # near-zero slope: whole-axis scan
    return f, warps, masks * keep


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_kernels_skip_zero_tiles(dtype):
    """Both kernels on masks that are 0 over whole tiles (their skip paths)
    and on transforms that the backward stages in several passes: the forward
    bitwise apart from the sign of zeros, the backward within its
    tolerance; the kernels' own skip counts show that both paths ran. 48
    rows: a column of a 16-row map never needs more rows than shared memory
    holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    f, warps, masks = _torch_args(_tile_masks((2, 48, 128, 16, 10), 11),
                                  dtype)
    ref, ref_idx = twp.warp_fold_pallas_reference(f, warps, masks)
    fwd_stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    out, idx = twp.warp_fold(f.cuda(), warps.cuda(), masks.cuda(),
                             stats=fwd_stats)
    _fwd_equal(out, idx, ref, ref_idx, dtype)
    g = torch.tensor(np.random.default_rng(4).standard_normal(f.shape)
                     .astype(np.float32)).to(f.dtype)
    ref_df = twp.warp_fold_pallas_bwd_reference(g, warps, masks, ref_idx)
    bwd_stats = torch.zeros(3, dtype=torch.int64, device="cuda")
    df = twp.warp_fold_bwd(g.cuda(), warps.cuda(), masks.cuda(),
                           ref_idx.cuda(), stats=bwd_stats)
    _bwd_within(df, ref_df, dtype)
    skipped, pairs = fwd_stats.tolist()
    assert skipped > 0.5 * pairs
    skipped, multipass, pairs = bwd_stats.tolist()
    # (tile, part) pairs: 2 samples x (48/4 x 128/16) df tiles x 10 parts
    assert pairs == 2 * 12 * 8 * 10
    assert skipped > 0.3 * pairs and multipass > 0
