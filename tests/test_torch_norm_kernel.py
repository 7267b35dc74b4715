"""The Block norm's kernels (``csrc/volume_norm.cu``: ``volume_norm_fwd``,
``volume_norm_bwd``) behind ``ops.norm.VolumeNorm``.

CPU: the split plan covers every sample's row exactly, in 16-byte chunks,
and gives the card enough blocks, at every norm shape of the benchmark
cells at batch 32 (the discriminator's rows at 32 and 64); a CPU tensor
takes ``volume_instance_norm_reference``, bit for bit the op-by-op
function the port had before the kernels, and launches nothing; the
kernels' closed-form gradient equals autograd through the plain function
(float64); the wrapper refuses a non-dense view and a dtype other than
bfloat16 and float32.

CUDA (``-m cuda``, skipped without a card): the kernels against the plain
function on the card and autograd through it, at every norm shape of the
four cells at b32, bf16 and f32, NCHW and ``channels_last``, with
``dweight`` and ``dbias``. Tolerances: the kernels sum each sample in
another order than PyTorch's reductions, so the f32 statistics, and
through them every output, differ by f32 rounding (held within
``F32_REL`` of the largest magnitude); in bf16 the output and the
input's cotangent are rounded once from those f32 values, so an element
may take the neighbouring bf16 value (within one bf16 ulp of its own
magnitude, ``BF16_ULP``, beyond the f32 limit). Also: a constant sample,
the backward with the clamp's flag set and unset against its closed form,
two calls bit for bit, the launches counted and the only kernels a call
runs, a row length that is no multiple of the vector, an unaligned base
and a strided cotangent. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from pose_transfer_torch.models.networks import (decoder_filters_for,
                                                 encoder_filters_for)
from pose_transfer_torch.ops import norm as N

torch.set_num_threads(2)

BATCH = 32
# f32: the sums of up to 8.4 M values a sample in another order move the
# statistics by a few ulp; the outputs and cotangents are then within
# F32_REL of the largest magnitude
F32_REL = 1e-5
# bf16: one rounding of an f32 value that differs by f32 rounding may land
# on the neighbouring bf16 value: at most one ulp, 2^-7 of the magnitude
BF16_ULP = 2.0 ** -7


def _gen_shapes(image: int) -> list:
    """(C, H, W) of every normed volume of the deformable generator at
    ``image``²: the encoder Blocks but the last, every decoder Block."""
    enc = encoder_filters_for((image, image))
    dec = decoder_filters_for((image, image))
    shapes = [(c, image >> i, image >> i)
              for i, c in enumerate(enc[1:-1], start=1)]
    size = image >> (len(enc) - 1)
    for c in dec[:-1]:
        size *= 2
        shapes.append((c, size, size))
    return shapes


def _disc_shapes(image: int) -> list:
    """(C, H, W) of the discriminator's normed volumes: after its k4s2
    VALID conv, the k4s2p1 Blocks of 128, 256 and 512 filters."""
    size = (image - 4) // 2 + 1
    shapes = []
    for c in (128, 256, 512):
        size = size // 2
        shapes.append((c, size, size))
    return shapes


# every norm call's (N, C, H, W) in the four cells at b32: fashion-256
# (fashion256-train, fashion256-full) and h36m-224 (train, serving); the
# discriminator phase scores real and fake rows in one batch of 2N
CELL_SHAPES = sorted({(BATCH, *s) for img in (256, 224)
                      for s in _gen_shapes(img)}
                     | {(n, *s) for img in (256, 224)
                        for s in _disc_shapes(img) for n in (BATCH,
                                                             2 * BATCH)})


def test_cell_shapes_are_the_networks_norms():
    assert _gen_shapes(256) == [(128, 128, 128), (256, 64, 64),
                                (512, 32, 32), (512, 16, 16), (512, 8, 8),
                                (512, 8, 8), (512, 16, 16), (512, 32, 32),
                                (512, 64, 64), (256, 128, 128),
                                (128, 256, 256)]
    assert _gen_shapes(224)[-1] == (128, 224, 224) \
        and len(_gen_shapes(224)) == 9
    assert _disc_shapes(256) == [(128, 63, 63), (256, 31, 31), (512, 15, 15)]
    assert _disc_shapes(224) == [(128, 55, 55), (256, 27, 27), (512, 13, 13)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", CELL_SHAPES,
                         ids=["x".join(map(str, s)) for s in CELL_SHAPES])
def test_plan_covers_every_row_in_16_byte_chunks(shape, itemsize):
    n, m = shape[0], shape[1] * shape[2] * shape[3]
    vec, chunk, splits = N.plan(n, m, itemsize)
    assert vec * itemsize == 16                 # every cell shape vectorises
    assert m % vec == 0 and chunk % vec == 0
    # the chunks [s·chunk, min((s+1)·chunk, m)) tile the row: none empty
    assert (splits - 1) * chunk < m <= splits * chunk
    # enough blocks for the card's SMs, and a split keeps several loads a
    # thread
    assert n * splits >= N.SMS
    assert chunk >= N.THREADS * vec * N.MIN_LOADS or splits == 1


@pytest.mark.parametrize("n,m,itemsize", [(1, 315, 2), (3, 7, 4),
                                          (2, 1000, 2), (1, 8, 4)])
def test_plan_of_short_or_odd_rows(n, m, itemsize):
    vec, chunk, splits = N.plan(n, m, itemsize)
    assert vec == (16 // itemsize if m % (16 // itemsize) == 0 else 1)
    assert chunk % vec == 0 and (splits - 1) * chunk < m <= splits * chunk


def _op_by_op(x, weight, bias, eps=1e-3):
    """The port's norm before the kernels, as it was."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    dims = tuple(range(1, x.ndim))
    mean = x32.mean(dim=dims, keepdim=True)
    msq = x32.square().mean(dim=dims, keepdim=True)
    var = torch.clamp(msq - mean.square(), min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def _grads(fn, x, w, b, g):
    x, w, b = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
    y = fn(x, w, b)
    y.backward(g)
    return y.detach(), x.grad, w.grad, b.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_cpu_takes_the_plain_code_bit_for_bit(dtype, layout):
    before = dict(N.LAUNCHES)
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn((3, 8, 5, 6), generator=gen) + 0.5).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(x.shape, generator=gen).to(dtype)
    w, b = torch.tensor([1.7]), torch.tensor([-0.3])
    got = _grads(N.volume_instance_norm, x, w, b, g)
    want = _grads(_op_by_op, x, w, b, g)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e)
    assert N.LAUNCHES == before


def _closed_form(x, g, w, eps=1e-3):
    """The kernels' gradient formula (csrc/volume_norm.cu), per sample:
    dx = (g − mean g − c·x̂·mean(g·x̂))·rstd·w, dw = Σ g·x̂, db = Σ g; c = 0
    where the clamp holds the variance at 0."""
    dims = tuple(range(1, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    d = x.square().mean(dim=dims, keepdim=True) - mean.square()
    rstd = torch.rsqrt(d.clamp(min=0.0) + eps)
    xh = (x - mean) * rstd
    c = (d >= 0).to(x.dtype)
    dx = (g - g.mean(dim=dims, keepdim=True)
          - c * xh * (g * xh).mean(dim=dims, keepdim=True)) * rstd * w
    return dx, (g * xh).sum().reshape(1), g.sum().reshape(1)


def _chain64(x, weight, bias, eps=1e-3):
    """The plain function's operations in float64 (it computes in f32)."""
    dims = tuple(range(1, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    msq = x.square().mean(dim=dims, keepdim=True)
    var = torch.clamp(msq - mean.square(), min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def test_closed_form_gradient_is_autograds():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((4, 6, 7, 5), generator=gen, dtype=torch.float64) * 3 + 1
    g = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    w = torch.tensor([0.8], dtype=torch.float64)
    b = torch.tensor([0.1], dtype=torch.float64)
    _, dx, dw, db = _grads(_chain64, x, w, b, g)
    want = _closed_form(x, g, w)
    for a, e in zip((dx, dw, db), want):
        torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros((2, 8, 6, 6))[:, ::2],             # channel slice
    lambda: torch.zeros((2, 6, 8, 4)).permute(0, 2, 1, 3),  # H and C swapped
    lambda: torch.zeros((2, 8, 6, 6)).transpose(2, 3),
    lambda: torch.zeros((4, 16, 4)).permute(1, 0, 2),       # batch not outer
])
def test_rows_refuses_a_non_dense_view(make):
    with pytest.raises(ValueError, match="dense"):
        N.rows(make())


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_rows_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        N.rows(torch.zeros((2, 4, 3, 3), dtype=dtype))


def test_rows_of_both_dense_formats():
    x = torch.zeros((3, 8, 5, 6))
    assert N.rows(x) == (3, 240)
    assert N.rows(x.contiguous(memory_format=torch.channels_last)) \
        == (3, 240)
    assert N.rows(torch.zeros((2, 9, 4))) == (2, 36)
    with pytest.raises(ValueError, match="non-empty"):
        N.rows(torch.zeros((0, 4, 2, 2)))


# ---------------------------------------------------------------- CUDA ---

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, layout, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    # an offset and scale like a convolution's output, so that the
    # one-pass variance has a mean to cancel
    x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.7).to(dtype)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
        g = g.contiguous(memory_format=torch.channels_last)
    w = torch.tensor([1.3], device=dev)
    b = torch.tensor([-0.2], device=dev)
    return x, g, w, b


def _within(got, want, dtype):
    """Each element within F32_REL of the largest magnitude, and in bf16
    one ulp of its own beyond that."""
    got, want = got.float(), want.float()
    tol = F32_REL * want.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + BF16_ULP * want.abs()
    return bool(((got - want).abs() <= tol).all())


def _check_against_plain(x, g, w, b):
    before = dict(N.LAUNCHES)
    y, dx, dw, db = _grads(N.volume_instance_norm, x, w, b, g)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in N.LAUNCHES.items()}
    assert launched == {"volume_norm_fwd": 1, "volume_norm_bwd": 1}
    assert y.dtype == x.dtype and y.stride() == x.stride()
    assert dx.dtype == x.dtype and dx.stride() == x.stride()
    ry, rdx, rdw, rdb = _grads(N.volume_instance_norm_reference, x, w, b, g)
    assert _within(y, ry, x.dtype)
    assert _within(dx, rdx, x.dtype)
    # the affine's gradients: sums over every element, in f32
    gx = (g.float() * ((ry.float() - b) / w)).abs().sum()
    assert (dw - rdw).abs().item() <= F32_REL * gx.item()
    assert (db - rdb).abs().item() <= F32_REL * g.float().abs().sum().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CELL_SHAPES,
                         ids=["x".join(map(str, s)) for s in CELL_SHAPES])
def test_cuda_kernels_match_plain_at_the_cells_shapes(shape, dtype):
    dev = _cuda()
    for layout in ("channels_last", "nchw"):
        x, g, w, b = _inputs(shape, dtype, layout, sum(shape), dev)
        _check_against_plain(x, g, w, b)
        del x, g
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_odd_rows_unaligned_base_and_strided_cotangent(dtype):
    dev = _cuda()
    # a row of 3·5·7 = 105 elements: one element a load
    x, g, w, b = _inputs((3, 3, 5, 7), dtype, "nchw", 5, dev)
    _check_against_plain(x, g, w, b)
    # a dense view 2 elements into its storage: not 16-byte aligned
    flat = torch.randn(2 + 4 * 64 * 9 * 9, device=dev).to(dtype)
    x = flat[2:].view(4, 64, 9, 9)
    assert x.data_ptr() % 16 and x.is_contiguous()
    _check_against_plain(x, torch.randn_like(x), w, b)
    # the cotangent a slice of a wider one, as a concatenation's backward
    # hands it on
    x, _, w, b = _inputs((2, 64, 12, 12), dtype, "channels_last", 6, dev)
    wide = torch.randn((2, 96, 12, 12), device=dev).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    _check_against_plain(x, wide[:, :64], w, b)


@pytest.mark.cuda
def test_cuda_constant_sample_and_the_clamp_flag():
    dev = _cuda()
    x, g, w, b = _inputs((4, 128, 16, 16), torch.float32, "channels_last", 7,
                         dev)
    x[1] = 0.1                      # variance 0 up to rounding: clamped or 0
    x[2] = 3.0                      # exact sums: variance exactly 0
    _check_against_plain(x, g, w, b)
    y, stats = N.volume_norm_fwd(x, w, b, 1e-3)
    assert (y[1:3] - b).abs().max().item() <= 1e-5
    # the backward with the flag unset (clamped: the variance term drops
    # out) and set, against the closed form in f64 from the same statistics
    x64, g64 = x.double(), g.double()
    for flag in (0.0, 1.0):
        st = stats.clone()
        st[:, 2] = flag
        dx, dwb = N.volume_norm_bwd(x, N._like(g, x), w, st)
        mean = st[:, 0].double().reshape(-1, 1, 1, 1)
        rstd = st[:, 1].double().reshape(-1, 1, 1, 1)
        xh = (x64 - mean) * rstd
        dims = (1, 2, 3)
        want = (g64 - g64.mean(dims, keepdim=True)
                - flag * xh * (g64 * xh).mean(dims, keepdim=True)) \
            * rstd * w.double()
        assert _within(dx, want, torch.float32)
        assert abs(dwb[0].item() - (g64 * xh).sum().item()) \
            <= F32_REL * (g64 * xh).abs().sum().item()
        assert abs(dwb[1].item() - g64.sum().item()) \
            <= F32_REL * g64.abs().sum().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_repeats_bit_for_bit(dtype):
    dev = _cuda()
    x, g, w, b = _inputs((32, 256, 64, 64), dtype, "channels_last", 8, dev)
    first = _grads(N.volume_instance_norm, x, w, b, g)
    for _ in range(2):
        again = _grads(N.volume_instance_norm, x, w, b, g)
        for a, e in zip(again, first):
            assert torch.equal(a, e)


@pytest.mark.cuda
def test_cuda_runs_only_the_two_kernels_each_way():
    dev = _cuda()
    x, g, w, b = _inputs((8, 128, 32, 32), torch.bfloat16, "channels_last",
                         9, dev)
    x.requires_grad_(True)
    N.volume_instance_norm(x, w, b)             # build and load first
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        y = N.volume_instance_norm(x, w, b)
        torch.cuda.synchronize()
    fwd = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
    bwd = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(fwd) == 2 and all("volume_norm_fwd" in k for k in fwd), fwd
    assert len(bwd) == 2 and all("volume_norm_bwd" in k for k in bwd), bwd


@pytest.mark.cuda
def test_cuda_refuses_what_the_kernels_do_not_take():
    dev = _cuda()
    one = torch.ones(1, device=dev)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        N.volume_instance_norm(torch.zeros((2, 4, 3, 3), device=dev,
                                           dtype=torch.float16), one, one)
    with pytest.raises(ValueError, match="dense"):
        N.volume_instance_norm(torch.zeros((2, 8, 3, 3), device=dev)[:, ::2],
                               one, one)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 16, 16, 8)])
def test_cuda_matches_jax(shape):
    """``tests/test_torch_ops.py``'s comparison with the JAX package, on
    CUDA tensors (that file imports the JAX data package, which needs
    ``imageio``; JAX is imported here inside the test, on the CPU)."""
    dev = _cuda()
    jnp = pytest.importorskip("jax.numpy")
    from pose_transfer_tpu.ops.norm import volume_instance_norm as jnorm
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) + 0.5).astype(np.float32)
    xt = torch.tensor(x, device=dev)
    one, zero = torch.ones(1, device=dev), torch.zeros(1, device=dev)
    got = N.volume_instance_norm(xt, one, zero).cpu()
    ref = jnorm(jnp.asarray(x), jnp.float32(1.0), jnp.float32(0.0))
    # against the exact stats (float64) atol 1e-6, as on the CPU: outputs
    # of magnitude ≤ 4, about two f32 ulp
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(1, 2, 3), keepdims=True)
    var = (x64 ** 2).mean(axis=(1, 2, 3), keepdims=True) - mean ** 2
    np.testing.assert_allclose(got.numpy(), (x64 - mean) / np.sqrt(var + 1e-3),
                               atol=1e-6, rtol=0)
    # against JAX 3e-6: XLA's CPU reduction sums in sequence (its f32 mean
    # off by up to ~4e-7), and that error scales every output
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-6,
                               rtol=0)
    # the scalar affine on the same f32 normalized values, bit for bit
    w = torch.tensor([1.7], device=dev)
    b = torch.tensor([-0.3], device=dev)
    assert torch.equal(N.volume_instance_norm(xt, w, b),
                       got.to(dev) * w + b)
    # the stats cover C·H·W per sample: layout-free
    nchw = N.volume_instance_norm(xt.permute(0, 3, 1, 2), one, zero).cpu()
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), got.numpy(),
                               atol=1e-6, rtol=0)
    assert N.volume_instance_norm(xt.bfloat16(), one, zero).dtype \
        == torch.bfloat16
