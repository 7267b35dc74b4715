"""Volume instance normalization — the reference's Block norm quirk.

Counterpart of ``pose_transfer_tpu/ops/norm.py``. The reference applies
``nn.InstanceNorm3d(1, eps=1e-3, affine=True)`` to the activation viewed as
(N, 1, C, H, W): statistics over the whole (C, H, W) volume per sample and
one scalar weight/bias pair per layer — not per-channel instance norm.

On a CUDA tensor both directions run the hand-written kernels of
``csrc/volume_norm.cu`` (``VolumeNorm``; built by
``pose_transfer_torch._build``): two passes forward (the statistics, then
the output), two backward (the cotangent's two sums, then the input's
cotangent with the affine's), in place of the op-by-op f32 chain and its
three saved f32 volumes. The backward keeps ``x`` and one (mean, rstd)
pair a sample. They take a bfloat16 or float32 ``x`` that is dense in the
NCHW-contiguous or the ``channels_last`` format (a sample's volume is then
one run of memory) and raise on anything else; no path falls back from the
kernels to the plain code. A CPU tensor takes the plain code
(``volume_instance_norm_reference``), which stays the tests' oracle. The
kernels sum in another order than the plain code, so the statistics, and
through them the outputs, may differ in their last bits; a call repeats
bit for bit. ``LAUNCHES`` counts the kernels' calls (registered with
``ops.launches``).
"""

from __future__ import annotations

import struct

import torch

from .launches import count_launch, kernel_lib, launch, register

LAUNCHES = register({"volume_norm_fwd": 0, "volume_norm_bwd": 0})

THREADS = 256            # a block's threads (csrc/volume_norm.cu kThreads)
SMS = 132                # an H100 SXM's multiprocessors
BLOCKS_PER_SM = 8        # 2048 threads an SM
MIN_LOADS = 2            # 16-byte loads a thread makes in a split, at least
MAX_SAMPLES = 65535      # the grid's second dimension
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def volume_instance_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                                   bias: torch.Tensor,
                                   eps: float = 1e-3) -> torch.Tensor:
    """The plain version: the op-by-op f32 chain, differentiated by
    autograd. Layout-free: the stats cover dims 1.., so NHWC and NCHW
    inputs give the same result. One-pass f32 stats (E[x], E[x²]), biased
    variance clamped at 0, eps inside the rsqrt; the output has ``x``'s
    dtype."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    dims = tuple(range(1, x.ndim))
    mean = x32.mean(dim=dims, keepdim=True)
    msq = x32.square().mean(dim=dims, keepdim=True)
    var = torch.clamp(msq - mean.square(), min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def plan(n: int, m: int, itemsize: int) -> tuple[int, int, int]:
    """(vec, chunk, splits) for ``n`` rows of ``m`` elements: ``vec``
    elements a load (16 bytes where ``m`` allows, else 1), each row cut
    into ``splits`` chunks of ``chunk`` elements (a multiple of ``vec``;
    the last chunk may be shorter, none is empty), so that the ``n`` ×
    ``splits`` blocks fill the card at every shape, while a split keeps at
    least ``MIN_LOADS`` loads a thread."""
    vec = 16 // itemsize
    if m % vec:
        vec = 1
    want = -(-SMS * BLOCKS_PER_SM // n)
    splits = max(1, min(want, m // (THREADS * vec * MIN_LOADS)))
    chunk = -(-m // splits)
    chunk = -(-chunk // vec) * vec
    return vec, chunk, -(-m // chunk)


def rows(x: torch.Tensor) -> tuple[int, int]:
    """(N, M): ``x`` as N rows of its M = numel / N elements a sample, for
    the kernels; raises on what they do not take."""
    if x.dtype not in DTYPES:
        raise TypeError("volume_norm: the kernels take bfloat16 or float32, "
                        f"got {x.dtype}")
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError("volume_norm: needs a non-empty (N, ...) tensor, "
                         f"got {tuple(x.shape)}")
    if not (x.is_contiguous() or (
            x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last))):
        raise ValueError("volume_norm: x must be dense in the NCHW or the "
                         f"channels_last format, got strides {x.stride()} "
                         f"for shape {tuple(x.shape)}")
    n = x.shape[0]
    if n > MAX_SAMPLES:
        raise ValueError(f"volume_norm: at most {MAX_SAMPLES} samples, "
                         f"got {n}")
    return n, x.numel() // n


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` (x's shape) dense in ``x``'s memory format, in ``x``'s dtype,
    16-byte aligned: element k of a sample's row is the same element in
    both."""
    fmt = torch.contiguous_format if x.is_contiguous() \
        else torch.channels_last
    t = t.to(x.dtype).contiguous(memory_format=fmt)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=fmt)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    return x if x.data_ptr() % 16 == 0 \
        else x.clone(memory_format=torch.preserve_format)


def _scalar(t: torch.Tensor, x: torch.Tensor, what: str) -> torch.Tensor:
    if t.numel() != 1 or t.device != x.device:
        raise ValueError(f"volume_norm: {what} must be one value on "
                         f"{x.device}, got {tuple(t.shape)} on {t.device}")
    return t.detach().to(torch.float32).reshape(1).contiguous()


def volume_norm_fwd(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float):
    """The forward kernels on a CUDA ``x`` (``rows`` checked, 16-byte
    aligned), f32 one-element ``weight`` and ``bias`` → (y in x's dtype and
    memory format, (N, 4) f32 statistics (mean, rstd, clamp flag, 0) for
    the backward)."""
    n, m = rows(x)
    vec, chunk, splits = plan(n, m, x.element_size())
    dev = x.device
    y = torch.empty_like(x, memory_format=torch.preserve_format)
    partial = torch.empty((n * splits, 2), dtype=torch.float32, device=dev)
    stats = torch.empty((n, 4), dtype=torch.float32, device=dev)
    eps_bits = struct.unpack("<i", struct.pack("<f", eps))[0]
    lib = kernel_lib("volume_norm", 6, 7, "volume_norm_fwd")
    launch("volume_norm_fwd", lib, dev, x.data_ptr(), weight.data_ptr(),
           bias.data_ptr(), y.data_ptr(), partial.data_ptr(),
           stats.data_ptr(), n, m, splits, chunk, vec, DTYPES[x.dtype],
           eps_bits, source="volume_norm")
    count_launch(LAUNCHES, "volume_norm_fwd")
    return y, stats


def volume_norm_bwd(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                    stats: torch.Tensor):
    """The backward kernels: ``g`` the output's cotangent laid out as
    ``x`` (``_like``), ``stats`` the forward's → (dx in x's dtype and
    memory format, (2,) f32 (dweight, dbias))."""
    n, m = rows(x)
    vec, chunk, splits = plan(n, m, x.element_size())
    dev = x.device
    dx = torch.empty_like(x, memory_format=torch.preserve_format)
    partial = torch.empty((n * splits, 2), dtype=torch.float32, device=dev)
    dwb = torch.empty((2,), dtype=torch.float32, device=dev)
    lib = kernel_lib("volume_norm", 7, 6, "volume_norm_bwd")
    launch("volume_norm_bwd", lib, dev, x.data_ptr(), g.data_ptr(),
           weight.data_ptr(), stats.data_ptr(), partial.data_ptr(),
           dx.data_ptr(), dwb.data_ptr(), n, m, splits, chunk, vec,
           DTYPES[x.dtype], source="volume_norm")
    count_launch(LAUNCHES, "volume_norm_bwd")
    return dx, dwb


class VolumeNorm(torch.autograd.Function):
    """``volume_instance_norm`` on the card. Saved: ``x`` (which its
    producer holds anyway), the f32 weight and the (N, 4) statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        rows(x)
        x = _aligned(x)
        w32, b32 = _scalar(weight, x, "weight"), _scalar(bias, x, "bias")
        y, stats = volume_norm_fwd(x, w32, b32, eps)
        ctx.save_for_backward(x, w32, stats)
        ctx.param_meta = (weight.shape, weight.dtype, bias.shape, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w32, stats = ctx.saved_tensors
        dx, dwb = volume_norm_bwd(x, _like(g, x), w32, stats)
        w_shape, w_dtype, b_shape, b_dtype = ctx.param_meta
        dw = dwb[0].reshape(w_shape).to(w_dtype) \
            if ctx.needs_input_grad[1] else None
        db = dwb[1].reshape(b_shape).to(b_dtype) \
            if ctx.needs_input_grad[2] else None
        return (dx if ctx.needs_input_grad[0] else None), dw, db, None


def volume_instance_norm(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Normalize over every non-batch dimension per sample, scalar affine:
    the kernels on a CUDA tensor, the plain version elsewhere."""
    if x.device.type == "cuda":
        return VolumeNorm.apply(x, weight, bias, eps)
    return volume_instance_norm_reference(x, weight, bias, eps)
