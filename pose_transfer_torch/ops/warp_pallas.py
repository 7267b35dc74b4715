"""The fused two-pass warp fold (``warp_backend='pallas'``): forward and
backward.

Counterpart of ``pose_transfer_tpu/ops/warp_pallas.py``. The fold is
max_t(two-pass-warp_t(features) · mask_t) with the argmax kept for the
backward: pass 1 (vertical) tmp[o, x] = Σ_y ramp(v(x, o) − y)·f[y, x],
pass 2 (horizontal) z[o, xo] = Σ_x ramp(u(xo, o) − x)·tmp[o, x], with
ramp(d) = max(0, 1 − |d|), so every output pixel needs only 2×2 feature
taps per part. The TPU kernels build the banded ramp matrices in VMEM and
feed them to the matrix unit; the CUDA kernels here (``csrc/warp_fold.cu``,
``csrc/warp_fold_bwd.cu``) evaluate the taps directly, with no banded
matrix and no ``tmp`` in device memory.

Pieces, as for every kernel of the port:
- the wrappers ``warp_fold`` and ``warp_fold_bwd``. A CPU tensor takes the
  plain version; a CUDA tensor launches the kernel or raises. Neither output
  carries a gradient, so both refuse, under grad mode, an input that
  requires grad: the fold is differentiated by ``WarpFoldPallas``.
- the plain PyTorch versions ``warp_fold_pallas_reference`` and
  ``warp_fold_pallas_bwd_reference``.
- ``LAUNCHES``: how many times each kernel was launched (``warp_fold_idx``
  counts the forward launches that emitted the argmax), registered with
  ``ops.launches``.
- the span ``fold.bwd.<h>x<w>`` (``utils.spans``, branch 'pallas') around
  ``WarpFoldPallas``'s backward; ``ops.warp`` spans the forward.

Numerics, where the TPU kernel rounds (and where it differs from the
matmul branch of ``ops/warp.py``):
- positions: pass 1 v = fl(fl(m11·(o+½)) + fl(ty−½)) + fl(m10·(x+½)),
  pass 2 u = fl(fl(m00·(xo+½)) + fl(tx−½)) + fl(m01·(o+½)), in f32;
- forward: ramp weights rounded to the features' dtype, sums exact
  products rounded once to f32, ``tmp`` rounded to the dtype; z stays f32,
  is multiplied by the f32 mask, then rounded once; part 0 is assigned,
  later parts win on a strict f32 ``>`` (the earliest part wins ties);
- backward: f32 ramp weights, dz = where(idx == t, g, 0)·mask in f32,
  dtmp rounded to the dtype, each part's df_t rounded to the dtype and
  accumulated over the parts in the dtype, in part order.
The plain versions' dots run in float64: every product of two f32 (or
bf16) values is exact there, so a forward sum of at most two products is
one rounding whatever order a GEMM takes, and the kernels (which sum the
same terms in f64, or in f32 where the products are bf16 values) agree with
them bit for bit, but for the sign of zeros: the forward kernel folds +0
for a part whose mask is 0 and skips its taps, where the plain version
rounds z·0 to z's signed zero. The argmax is int8 (JAX: int32; T ≤ 127).
"""

from __future__ import annotations

import re
from pathlib import Path

import torch

from ..utils.spans import span
from . import warp_fused
from .launches import count_launch, kernel_lib, launch, register

OB = 8   # the TPU kernels' row and column blocks: the shape gate below
XB = 8

LAUNCHES = register({"warp_fold": 0, "warp_fold_idx": 0,
                     "warp_fold_bwd": 0})

_DTYPE_CODES = warp_fused._DTYPE_CODES


def supported(h: int, w: int) -> bool:
    """The JAX package's gate for the Pallas branch (its Mosaic tiling
    rules), kept so that the same stages take the same branch; the CUDA
    kernels themselves take any H and W."""
    return h % OB == 0 and w % XB == 0 and w % 128 == 0


def _ramp(pos: torch.Tensor, n: int) -> torch.Tensor:
    """(...,) f32 positions → (..., n) f32 weights max(0, 1 − |pos − j|)."""
    j = torch.arange(n, dtype=torch.float32, device=pos.device)
    return torch.clamp(1.0 - (pos[..., None] - j).abs(), min=0.0)


def _positions(coef: torch.Tensor, n: int, offset: torch.Tensor):
    """(N, n) f32 positions fl(fl(coef·(i + ½)) + offset) of (N,) coef and
    offset, as the TPU kernel's ``_positions``."""
    i = torch.arange(n, dtype=torch.float32, device=coef.device) + 0.5
    return coef[:, None] * i + offset[:, None]


def _v_pos(warps: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pass-1 positions v: (N, W, H_out), v[x, o] = base_y[o] +
    fl(m10·(x + ½)) with base_y = _positions(m11, H, ty − ½)."""
    m10, m11, ty = warps[:, 3], warps[:, 4], warps[:, 5]
    base = _positions(m11, h, ty - 0.5)                          # (N, H)
    xs = torch.arange(w, dtype=torch.float32, device=warps.device) + 0.5
    return base[:, None, :] + (m10[:, None] * xs)[:, :, None]


def _u_pos(warps: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pass-2 positions u: (N, H_out, W_out), u[o, xo] = base_x[xo] +
    fl(m01·(o + ½)) with base_x = _positions(m00, W, tx − ½)."""
    m00, m01, tx = warps[:, 0], warps[:, 1], warps[:, 2]
    base = _positions(m00, w, tx - 0.5)                          # (N, W)
    os_ = torch.arange(h, dtype=torch.float32, device=warps.device) + 0.5
    return base[:, None, :] + (m01[:, None] * os_)[:, :, None]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 result of a float64 matrix product: the products are exact, the
    sum rounds in f64 and once more to f32."""
    return torch.matmul(a.double(), b.double()).float()


def _warp_part(features: torch.Tensor, warps_t: torch.Tensor):
    """One part's two-pass warp, before the mask: (N, H, W, C) features,
    (N, 8) f32 transforms → (N, H, W, C) f32 z."""
    _, h, w, _ = features.shape
    dtype = features.dtype
    # pass 1: tmp[n, x, o, c] = Σ_y wy[n, x, o, y]·f[n, y, x, c]
    wy = _ramp(_v_pos(warps_t, h, w), h).to(dtype)          # (N, W, H, H)
    tmp = _dot(wy, features.permute(0, 2, 1, 3)).to(dtype)  # (N, W, H, C)
    # pass 2: z[n, o, xo, c] = Σ_x wx[n, o, xo, x]·tmp[n, o, x, c]
    wx = _ramp(_u_pos(warps_t, h, w), w).to(dtype)          # (N, H, W, W)
    return _dot(wx, tmp.permute(0, 2, 1, 3))                # (N, H, W, C)


def warp_fold_pallas_reference(features: torch.Tensor,
                               warps_scaled: torch.Tensor,
                               masks_r: torch.Tensor, emit_idx: bool = True):
    """Plain PyTorch version of ``warp_fold`` (same arguments/results).
    Loops over the parts, so its memory stays at one part's banded
    weights."""
    t_parts = warps_scaled.shape[1]
    out = idx = None
    for t in range(t_parts):
        z = _warp_part(features, warps_scaled[:, t])
        # the mask multiplies the f32 z before the one rounding
        zm = (z * masks_r[:, t].float()[..., None]).to(features.dtype)
        if t == 0:
            out = zm
            if emit_idx:
                idx = torch.zeros(zm.shape, dtype=torch.int8,
                                  device=zm.device)
            continue
        take = zm.float() > out.float()          # strict: earliest part wins
        out = torch.where(take, zm, out)
        if emit_idx:
            idx = torch.where(take, torch.full_like(idx, t), idx)
    return out, idx


def warp_fold_pallas_bwd_reference(g: torch.Tensor,
                                   warps_scaled: torch.Tensor,
                                   masks_r: torch.Tensor,
                                   idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``warp_fold_bwd`` (same arguments/result)."""
    _, h, w, _ = g.shape
    dtype = g.dtype
    zero = torch.zeros((), dtype=dtype, device=g.device)
    acc = None
    for t in range(warps_scaled.shape[1]):
        tr = warps_scaled[:, t]
        dz = torch.where(idx == t, g, zero).float() \
            * masks_r[:, t].float()[..., None]                  # (N, H, W, C)
        # pass 2ᵀ: dtmp[n, o, x, c] = Σ_xo wx[n, o, xo, x]·dz[n, o, xo, c]
        wx = _ramp(_u_pos(tr, h, w), w)                          # f32 weights
        dtmp = _dot(wx.transpose(-1, -2), dz).to(dtype)         # (N, H, W, C)
        # pass 1ᵀ: df[n, x, y, c] = Σ_o wy[n, x, o, y]·dtmp[n, o, x, c]
        wy = _ramp(_v_pos(tr, h, w), h)
        df = _dot(wy.transpose(-1, -2), dtmp.permute(0, 2, 1, 3)) \
            .to(dtype).permute(0, 2, 1, 3)                      # (N, H, W, C)
        # accumulated in the dtype, in part order
        acc = df if acc is None else (acc.float() + df.float()).to(dtype)
    return acc.contiguous()


# ------------------------------------------------ the backward's box rule
#
# warp_fold_bwd (csrc/warp_fold_bwd.cu) skips a (tile, part) pair whose
# mask is 0 wherever the part's taps reach the tile. Its first test is a
# box of output pixels per tile of df: ``bwd_boxes`` computes the same box
# in torch, so that the CPU tests can hold it against brute force (it must
# hold every output pixel with a nonzero weight to the tile). The tile and
# the slope below which an axis is scanned whole are read from the kernel's
# source. What the kernels skip on given inputs they count themselves
# (the ``stats`` argument of ``warp_fold`` and ``warp_fold_bwd``).


def _kernel_constants(name: str) -> dict:
    """The ``constexpr int`` / ``float`` constants ``k...`` of
    ``csrc/<name>.cu``."""
    src = (Path(__file__).resolve().parents[1] / "csrc" / f"{name}.cu") \
        .read_text()
    return {k: float(v) for k, v in re.findall(
        r"constexpr (?:int|float) (k\w+) = ([0-9.e+-]+)f?;", src)}


_BWD = _kernel_constants("warp_fold_bwd")
BWD_TILE = (int(_BWD["kTileY"]), int(_BWD["kTileX"]))   # df tile (rows, cols)
MIN_SLOPE = _BWD["kMinSlope"]    # below it an axis is scanned whole


def _window(slope, c1, c2, a, b, n):
    """The kernel's index window along an axis of n: every i whose f32
    position slope·(i + ½) + c (c between c1 and c2, f64) can lie in
    (a − 1, b + 1): the real-arithmetic interval, floor/ceil, widened by 2
    on each side against the rounding of the position; the whole axis for
    |slope| < MIN_SLOPE or a bound that is not finite; (lo, hi) int64,
    lo > hi when empty. slope f32, c1/c2 f64, a/b integers, broadcast."""
    inv = 1.0 / slope.double()
    e1 = torch.as_tensor(a, dtype=torch.float64, device=slope.device) - 1.0
    e2 = torch.as_tensor(b, dtype=torch.float64, device=slope.device) + 1.0
    ends = [(e - c) * inv - 0.5 for e in (e1, e2) for c in (c1, c2)]
    p = torch.floor(torch.fmin(torch.fmin(ends[0], ends[1]),
                               torch.fmin(ends[2], ends[3]))) - 2.0
    q = torch.ceil(torch.fmax(torch.fmax(ends[0], ends[1]),
                              torch.fmax(ends[2], ends[3]))) + 2.0
    whole = ~(slope.abs() >= MIN_SLOPE) | ~(p.isfinite() & q.isfinite())
    empty = ~whole & ((q < 0) | (p > n - 1))
    lo = torch.where(whole, 0.0, p.clamp(min=0.0))
    hi = torch.where(whole, n - 1.0, q.clamp(max=n - 1.0))
    lo = torch.where(empty, 1.0, lo).long()
    hi = torch.where(empty, 0.0, hi).long()
    return lo, hi


def _tiles(n, size):
    """Start and last index of each tile of ``size`` along an axis of n."""
    a = torch.arange(0, n, size)
    return a, (a + size - 1).clamp(max=n - 1)


def bwd_boxes(warps_t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """For one part's (N, 8) scaled transforms, the (N, tiles_y, tiles_x, 4)
    [o_lo, o_hi, xo_lo, xo_hi] box of output pixels whose taps can reach
    each BWD_TILE tile of df (rows: v(x, o) within a tap of the tile's rows
    for x at the tile's two edge columns; columns: u(xo, o) within a tap of
    its columns for o at the rows' two ends)."""
    dev = warps_t.device
    m00, m01, tx, m10, m11, ty = (warps_t[:, i, None, None]
                                  for i in range(6))
    y_a, y_b = (t.to(dev)[:, None] for t in _tiles(h, BWD_TILE[0]))
    x_a, x_b = (t.to(dev)[None, :] for t in _tiles(w, BWD_TILE[1]))
    tyh, txh = (ty - 0.5).double(), (tx - 0.5).double()

    def off(coef, i, half):
        return half + (coef * (i.float() + 0.5)).double()
    o_lo, o_hi = _window(m11, off(m10, x_a, tyh), off(m10, x_b, tyh),
                         y_a, y_b, h)
    empty = o_lo > o_hi
    xo_lo, xo_hi = _window(m00, off(m01, o_lo, txh), off(m01, o_hi, txh),
                           x_a, x_b, w)
    xo_lo = torch.where(empty, 1, xo_lo)
    xo_hi = torch.where(empty, 0, xo_hi)
    return torch.stack(torch.broadcast_tensors(o_lo, o_hi, xo_lo, xo_hi), -1)


def _check(name, x, warps_scaled, masks_r, idx=None):
    if x.ndim != 4:
        raise ValueError(f"{name}: expected (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    n, h, w, c = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if warps_scaled.dtype != torch.float32 or masks_r.dtype != x.dtype:
        raise TypeError(f"{name}: warps must be float32 and masks in the "
                        "features' dtype")
    t = warps_scaled.shape[1]
    if tuple(warps_scaled.shape) != (n, t, 8) \
            or tuple(masks_r.shape) != (n, t, h, w):
        raise ValueError(f"{name}: warps {tuple(warps_scaled.shape)} / masks "
                         f"{tuple(masks_r.shape)} do not match {(n, h, w, c)}")
    if idx is not None and (idx.dtype != torch.int8 or idx.shape != x.shape):
        raise ValueError(f"{name}: idx must be int8 of the cotangent's shape")
    if not 1 <= t <= 127:
        raise ValueError(f"{name}: needs 1 <= T <= 127 (int8 argmax)")
    return n, h, w, c, t


def _no_stats(name, stats):
    if stats is not None:
        raise ValueError(f"{name}: stats counts what the CUDA kernel skips; "
                         "the plain version on the CPU skips nothing")


def _check_stats(name, stats, size, device):
    if stats is not None and (stats.dtype != torch.int64
                              or tuple(stats.shape) != (size,)
                              or stats.device != device
                              or not stats.is_contiguous()):
        raise ValueError(f"{name}: stats must be a contiguous int64 tensor "
                         f"of {size} on the kernel's device")


def warp_fold(features: torch.Tensor, warps_scaled: torch.Tensor,
              masks_r: torch.Tensor, emit_idx: bool = True,
              stats: torch.Tensor | None = None):
    """Fused two-pass warp, mask multiply and max fold over the parts.

    Args:
      features: (N, H, W, C) float32 or bfloat16.
      warps_scaled: (N, T, 8) float32 inverse affines, translations already
        scaled to the feature resolution.
      masks_r: (N, T, H, W) part masks at feature resolution, in the
        features' dtype (all ones for unmasked warping).
      emit_idx: also return the argmax (off on the no-grad path).
      stats: None (the main path), or an int64 tensor of 2 on the card, to
        which the kernel adds the (tile, part) pairs it skipped (the part's
        mask is 0 over the whole output tile) and all its pairs.

    Returns:
      (out (N, H, W, C), idx (N, H, W, C) int8 or None): the max fold and
      the winning part.
    """
    n, h, w, c, t = _check("warp_fold", features, warps_scaled, masks_r)
    tensors = (features, warps_scaled, masks_r)
    warp_fused._refuse_grad("warp_fold", tensors)
    if not warp_fused._on_card("warp_fold", tensors, c):
        _no_stats("warp_fold", stats)
        return warp_fold_pallas_reference(features, warps_scaled, masks_r,
                                          emit_idx)
    _check_stats("warp_fold", stats, 2, features.device)
    lib = kernel_lib("warp_fold", 6, 7)
    out = torch.empty_like(features)
    idx = torch.empty(features.shape, dtype=torch.int8,
                      device=features.device) if emit_idx else None
    launch(
        "warp_fold", lib, features.device, features.data_ptr(),
        warps_scaled.data_ptr(), masks_r.data_ptr(), out.data_ptr(),
        idx.data_ptr() if emit_idx else None,
        None if stats is None else stats.data_ptr(),
        n, h, w, c, t, _DTYPE_CODES[features.dtype], int(emit_idx))
    count_launch(LAUNCHES, "warp_fold",
                 *(("warp_fold_idx",) if emit_idx else ()))
    return out, idx


def warp_fold_bwd(g: torch.Tensor, warps_scaled: torch.Tensor,
                  masks_r: torch.Tensor, idx: torch.Tensor,
                  stats: torch.Tensor | None = None) -> torch.Tensor:
    """Feature gradient of ``warp_fold``: both transposed passes, the
    cotangent routed to the part the argmax names.

    Args:
      g: (N, H, W, C) cotangent, float32 or bfloat16.
      warps_scaled, masks_r: as for ``warp_fold``.
      idx: (N, H, W, C) int8 argmax from ``warp_fold``.
      stats: None (the main path), or an int64 tensor of 3 on the card, to
        which the kernel adds the (tile, part) pairs it skipped (no output
        pixel with a nonzero mask reaches the df tile), those it staged in
        more than one pass (a steep m11), and all its pairs.

    Returns:
      (N, H, W, C) df in g's dtype.
    """
    n, h, w, c, t = _check("warp_fold_bwd", g, warps_scaled, masks_r, idx)
    tensors = (g, warps_scaled, masks_r, idx)
    warp_fused._refuse_grad("warp_fold_bwd", tensors)
    if not warp_fused._on_card("warp_fold_bwd", tensors, c):
        _no_stats("warp_fold_bwd", stats)
        return warp_fold_pallas_bwd_reference(g, warps_scaled, masks_r, idx)
    _check_stats("warp_fold_bwd", stats, 3, g.device)
    lib = kernel_lib("warp_fold_bwd", 7, 6)
    df = torch.empty_like(g)
    bbox = torch.empty((n, t, 4), dtype=torch.int32, device=g.device)
    launch(
        "warp_fold_bwd", lib, g.device, g.data_ptr(), warps_scaled.data_ptr(),
        masks_r.data_ptr(), idx.data_ptr(), df.data_ptr(), bbox.data_ptr(),
        None if stats is None else stats.data_ptr(),
        n, h, w, c, t, _DTYPE_CODES[g.dtype])
    count_launch(LAUNCHES, "warp_fold_bwd")
    return df


class WarpFoldPallas(torch.autograd.Function):
    """The fused warp fold as an autograd Function (JAX: the custom VJP of
    ``warp_fold_pallas``): forward with the argmax; backward through
    ``warp_fold_bwd``. Saved: the scaled warps, the masks and the int8
    argmax. Gradient: features only; warps and masks get none (JAX returns
    zeros for them)."""

    @staticmethod
    def forward(ctx, features, warps_scaled, masks_r):
        out, idx = warp_fold(features, warps_scaled, masks_r, True)
        ctx.save_for_backward(warps_scaled, masks_r, idx)
        return out

    @staticmethod
    def backward(ctx, g):
        warps_scaled, masks_r, idx = ctx.saved_tensors
        # g reaches here through NCHW views and channel slices: the kernel
        # takes a contiguous, 16-byte aligned map
        if not g.is_contiguous() or g.data_ptr() % 16:
            g = g.clone(memory_format=torch.contiguous_format)
        with span(f"fold.bwd.{g.shape[1]}x{g.shape[2]}", branch="pallas"):
            return warp_fold_bwd(g, warps_scaled, masks_r, idx), None, None
