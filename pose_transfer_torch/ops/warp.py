"""Multi-transform affine feature warping and the max fold (the deformable op).

Counterpart of the ``backend='matmul'`` path of
``pose_transfer_tpu/ops/warp.py``, forward and backward. For each of the T
part transforms the appearance skip is warped by an inverse pixel-space
affine, multiplied by the part's mask (resized to the feature resolution),
and the T results are folded by max (or mean).

The warp is the two-pass (Catmull-Smith) resample of the JAX package — NOT
``grid_sample``: for a transform with m10 ≠ 0 the vertical taps are
evaluated at the source column, which differs from direct bilinear sampling
by up to |m10| px. Each output of either pass has at most two nonzero taps.
On the CPU the two passes are the JAX package's two banded-matrix products
(``_warp_win_banded``, ``_warp_win_t_banded``; on the card too inside
``banded_warps``, the references' context); on the card the
``warp_fused.warp_taps`` / ``warp_taps_t`` kernels compute the same taps,
weights and roundings from the transforms, with no weight matrices (their
f32 sums may differ from a product's in the last bit). Same math, same
numbers.

Three fold paths, chosen per fold instance:
- the full scan (``_fold_scan``): every part warped at full resolution,
  folded in order with strict ``>`` (earliest part wins ties);
- the windowed, kernel-placed fold (``_fold_windowed_place``): the body at
  full resolution, every other part only inside its mask's bounding-box
  window, placed by ``ops.warp_fused.fold_place``. Exact: outside its window
  a part's masked contribution is zero, which the zero pass restores;
- the windowed fold with XLA-style placement (``_fold_windowed``, the JAX
  package's ``place_impl='xla'``): the same windows, (h/2, w/2) and
  unaligned, placed part by part by a gather, compare and scatter of each
  window in plain PyTorch; the only windowed fold for ``warp_agg='avg'``.
``place_impl`` chooses between the two windowed placements: 'xla' always
the gather/scatter one; 'auto' and 'kernel' the placement kernel where the
shape qualifies (``_use_place_kernel``), else the gather/scatter one. (The
JAX package's 'auto' takes the kernel only on a TPU; the port's kernel runs
wherever the fold runs, so 'auto' is 'kernel'.)
The windowed fold needs every non-body part's support to fit its window.
The JAX package decides that with one ``lax.cond`` per fold instance; here
``plan_folds`` decides it for all fold instances of a forward with one host
sync.

The backward (``WarpFold``, the counterpart of ``warp_fold_matmul``'s custom
VJP) saves no feature maps: the warp is linear in the features, so it
routes the cotangent through the argmax and the transposed two-pass warps,
recomputing their taps. The kernel-placed branch routes with the
``fold_route`` kernel; warps and masks get no gradient (host data).

``backend='pallas'`` (the JAX package's ``warp_backend='pallas'``) sends
every fold instance whose shape passes ``warp_pallas.supported`` and whose
fold is a max to the fused two-pass warp fold of ``ops/warp_pallas.py``
(forward and backward kernels, ``WarpFoldPallas``); the other instances
take the branches above, as in the JAX package (``warp.py:1282-1293``).

``backend='exact'`` (the JAX package's ``warp_backend='exact'``) warps each
part directly: four bilinear taps gathered per output pixel at its
transformed position (``warp_feature_single``, ``grid_sample`` semantics
with zero padding), folded in part order by ``torch.maximum`` (or summed
for 'avg') and recomputed in the backward (``torch.utils.checkpoint``, as
the JAX package's ``jax.checkpoint``). It plans no windows and launches no
kernel: the JAX package has no Pallas kernel for it.

Spans (``utils.spans``, while a profiler records): ``fold.plan`` around
``plan_folds`` with ``fold.plan_sync`` around its one host sync;
``fold.fwd.<h>x<w>`` around each fold instance's forward and
``fold.bwd.<h>x<w>`` around ``WarpFold``'s backward, both with the
instance's ``FoldPlan.branch``.

Two environment variables bound the kernel-placed fold's memory, as in the
JAX package (``warp.py:436-553``, ``:870-1018``), and are read at every
call (the JAX package reads them when it traces):
- ``PT_WARP_PLACE_CHUNK_MB`` (default 3072): the batch runs through the
  whole fold, forward and backward, in chunks of ``_place_batch_chunk``
  samples, a smaller call for the remainder;
- ``PT_WARP_JOINT_GROUP`` (default 0, no grouping): the windowed warps of
  the parts run in groups of that many parts, forward (kernel-placed
  fold) and backward (both windowed folds).

Transforms are (T, 8) row-major first-8 of a 3×3 matrix acting on (x, y, 1),
estimated at ``init_image_size``; translations are rescaled per feature
resolution.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.utils.checkpoint

from ..utils.spans import span
from . import warp_fused, warp_pallas

BACKENDS = ("matmul", "pallas", "exact")

# fold instances that could have taken the windowed fold but fell back to
# the full scan because some part's support did not fit its window
COUNTS = {"scan_fallback": 0}


def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, cv2 INTER_LINEAR
    semantics: half-pixel centers, clamped borders, no antialiasing."""
    u = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    u0 = np.floor(u).astype(np.int64)
    frac = u - u0
    lo = np.clip(u0, 0, n_in - 1)
    hi = np.clip(u0 + 1, 0, n_in - 1)
    mat = np.zeros((n_out, n_in), np.float32)
    mat[np.arange(n_out), lo] += 1.0 - frac
    mat[np.arange(n_out), hi] += frac
    return mat


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize the trailing-2 spatial dims (..., H, W) → (..., h, w) like
    cv2.resize(..., INTER_LINEAR), as two static-matrix products computed
    in ``x``'s dtype."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    ry = torch.as_tensor(_resize_matrix(h_out, h_in), dtype=x.dtype,
                         device=x.device)
    rx = torch.as_tensor(_resize_matrix(w_out, w_in), dtype=x.dtype,
                         device=x.device)
    return torch.matmul(torch.matmul(ry, x), rx.t())


def _sample_coords(warps: torch.Tensor, h: int, w: int, scale_y: float,
                   scale_x: float):
    """Pixel-space sample positions (v, u), each (N, h, w) f32, of (N, 8)
    inverse affines; the translations scaled in the transforms' dtype, as
    in JAX."""
    m00, m01, tx, m10, m11, ty = (warps[:, k] for k in range(6))
    tx = tx * scale_x
    ty = ty * scale_y

    def col(v):          # (N,) → (N, 1, 1) f32
        return v.float()[:, None, None]

    dev = warps.device
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, None] + 0.5
    y = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + 0.5
    u = col(m00) * x + col(m01) * y + col(tx) - 0.5       # input x
    v = col(m10) * x + col(m11) * y + col(ty) - 0.5       # input y
    return v, u


def bilinear_sample(image: torch.Tensor, v: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with zero padding (``grid_sample`` semantics).

    Args:
      image: (N, H, W, C).
      v, u: (N, Ho, Wo) f32 sample positions (row, col) in pixel units.

    Returns:
      (N, Ho, Wo, C) samples in ``image``'s dtype: each tap's value times
      its f32 weight (0 out of bounds), the four summed in f32 in JAX's
      order, then rounded once.
    """
    n, h, w, c = image.shape
    ho, wo = v.shape[1:]
    v0 = torch.floor(v)
    u0 = torch.floor(u)
    fv = v - v0
    fu = u - u0
    v0 = v0.to(torch.int64)
    u0 = u0.to(torch.int64)
    flat = image.reshape(n * h * w, c)
    base = (torch.arange(n, device=image.device) * (h * w))[:, None, None]

    def tap(vi, ui, weight):
        valid = (vi >= 0) & (vi < h) & (ui >= 0) & (ui < w)
        idx = base + vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)
        vals = flat.index_select(0, idx.reshape(-1)).reshape(n, ho, wo, c)
        return vals * (weight * valid)[..., None]

    out = (tap(v0, u0, (1 - fv) * (1 - fu))
           + tap(v0, u0 + 1, (1 - fv) * fu)
           + tap(v0 + 1, u0, fv * (1 - fu))
           + tap(v0 + 1, u0 + 1, fv * fu))
    return out.to(image.dtype)


def warp_feature_single(features: torch.Tensor, warps: torch.Tensor,
                        init_image_size: tuple[int, int]) -> torch.Tensor:
    """Warp each (H, W, C) map of (N, H, W, C) features by its (8,) inverse
    affine of (N, 8) ``warps`` (the JAX function vmapped over the batch);
    the sample positions carry no gradient."""
    _, h, w, _ = features.shape
    v, u = _sample_coords(warps, h, w, scale_y=h / init_image_size[0],
                          scale_x=w / init_image_size[1])
    return bilinear_sample(features, v.detach(), u.detach())


def _fold_exact(features, warps, masks_r, init_image_size, warp_agg):
    """The 'exact' fold: every part warped by ``warp_feature_single``,
    masked, and folded in part order by ``torch.maximum`` from -inf (a tie
    splits the cotangent in half, as ``jnp.maximum``'s does) or summed in
    the features' dtype and divided by the part count."""
    n, h, w, c = features.shape
    t = warps.shape[1]
    if warp_agg == "max":
        acc = torch.full((n, h, w, c), float("-inf"), dtype=features.dtype,
                         device=features.device)
    else:
        acc = torch.zeros((n, h, w, c), dtype=features.dtype,
                          device=features.device)
    for i in range(t):
        warped = warp_feature_single(features, warps[:, i], init_image_size)
        if masks_r is not None:
            warped = warped * masks_r[:, i][..., None]
        acc = torch.maximum(acc, warped) if warp_agg == "max" \
            else acc + warped
    return acc / t if warp_agg == "avg" else acc


def _ramp(pos: torch.Tensor, n_in: int, dtype: torch.dtype) -> torch.Tensor:
    """Bilinear tap weights along one axis as a dense banded matrix:
    (...,) positions → (..., n_in) weights max(0, 1 - |pos - j|), rounded
    to ``dtype``. Out-of-range taps vanish (zero padding)."""
    j = torch.arange(n_in, dtype=torch.float32, device=pos.device)
    w = (pos[..., None] - j).abs_().neg_().add_(1.0).clamp_(min=0.0)
    return w.to(dtype)


def _warp_coeffs(warps: torch.Tensor, h: int, w: int,
                 init_image_size: tuple[int, int]):
    """(m00, m01, tx, m10, m11, ty) in f32 of (..., 8) transforms, the
    translation scaled to the (h, w) map in the transforms' dtype, as in
    JAX."""
    m00, m01, tx, m10, m11, ty = (warps[..., k] for k in range(6))
    tx = (tx * (w / init_image_size[1])).float()
    ty = (ty * (h / init_image_size[0])).float()
    m00, m01, m10, m11 = (m.float() for m in (m00, m01, m10, m11))
    return m00, m01, tx, m10, m11, ty


def _tap_coeffs(warps: torch.Tensor, h: int, w: int,
                init_image_size: tuple[int, int], y0: torch.Tensor,
                x0: torch.Tensor) -> torch.Tensor:
    """The tap kernels' (N, P, 8) f32 rows (m00, m01, tx, m10, m11, ty, y0,
    x0) of (N, P, 8) transforms and (N, P) window starts."""
    return torch.stack([*_warp_coeffs(warps, h, w, init_image_size),
                        y0.float(), x0.float()], dim=-1).contiguous()


def _two_pass_weights(warps: torch.Tensor, h: int, w: int,
                      init_image_size: tuple[int, int], dtype: torch.dtype,
                      y0: torch.Tensor, x0: torch.Tensor, s_y: int, s_x: int):
    """Banded weight matrices of the two-pass warp, restricted to the output
    windows [y0, y0+s_y) × [x0, x0+s_x) (the full map is y0 = x0 = 0,
    s_y = h, s_x = w: the windowed weights are a bit-exact subset).

    Args:
      warps: (N, P, 8) transforms in the compute dtype.
      y0, x0: (N, P) integer window starts.

    Returns:
      wy: (N, W, P, S_y, H) vertical-pass weights (v evaluated at the source
        column — the two-pass approximation; full x extent always).
      wx: (N, P, S_y, S_x, W) horizontal-pass weights.
    """
    dev = warps.device
    m00, m01, tx, m10, m11, ty = _warp_coeffs(warps, h, w, init_image_size)
    ar_y = torch.arange(s_y, dtype=torch.float32, device=dev)
    ar_x = torch.arange(s_x, dtype=torch.float32, device=dev)
    y_out = y0.float()[..., None] + ar_y + 0.5                # (N, P, S_y)
    x_out = x0.float()[..., None] + ar_x + 0.5                # (N, P, S_x)
    x_full = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    # v: (N, W, P, S_y)
    v = (m10[:, None, :, None] * x_full[None, :, None, None]
         + m11[:, None, :, None] * y_out[:, None]
         + ty[:, None, :, None] - 0.5)
    wy = _ramp(v, h, dtype)
    # u: (N, P, S_y, S_x)
    u = (m00[..., None, None] * x_out[:, :, None, :]
         + m01[..., None, None] * y_out[..., None]
         + tx[..., None, None] - 0.5)
    wx = _ramp(u, w, dtype)
    return wy, wx


# set inside ``banded_warps``: the warps run the banded products on the card
_banded_on_card = False


@contextlib.contextmanager
def banded_warps():
    """Inside the block, ``_warp_win`` and ``_warp_win_t`` compute the dense
    banded products on the card too, as on the CPU: the reference that the
    tap kernels are held to, and the plain fold that autograd
    differentiates (the tap kernels take no input that requires grad)."""
    global _banded_on_card
    saved = _banded_on_card
    _banded_on_card = True
    try:
        yield
    finally:
        _banded_on_card = saved


def _warp_win(features: torch.Tensor, warps: torch.Tensor,
              y0: torch.Tensor, x0: torch.Tensor, s_y: int, s_x: int,
              init_image_size: tuple[int, int]) -> torch.Tensor:
    """Windowed two-pass warps of every part: (N, H, W, C) features,
    (N, P, 8) transforms, (N, P) window starts → (N, P, S_y, S_x, C).

    Both passes accumulate in f32 and round once to the features' dtype,
    as the JAX package's ``preferred_element_type`` dots do. On the card
    the ``warp_taps`` kernel computes them from their taps; on the CPU the
    banded products (``_warp_win_banded``), as on the card inside
    ``banded_warps``.
    """
    if features.is_cuda and not _banded_on_card:
        _, h, w, _ = features.shape
        return warp_fused.warp_taps(
            features.contiguous(),
            _tap_coeffs(warps, h, w, init_image_size, y0, x0), s_y, s_x)
    return _warp_win_banded(features, warps, y0, x0, s_y, s_x,
                            init_image_size)


def _warp_win_banded(features: torch.Tensor, warps: torch.Tensor,
                     y0: torch.Tensor, x0: torch.Tensor, s_y: int, s_x: int,
                     init_image_size: tuple[int, int]) -> torch.Tensor:
    """``_warp_win`` as two products by the dense banded weights of
    ``_two_pass_weights``."""
    n, h, w, c = features.shape
    p = warps.shape[1]
    wy, wx = _two_pass_weights(warps, h, w, init_image_size, features.dtype,
                               y0, x0, s_y, s_x)
    # pass 1 (vertical): tmp[n, x, (p, o), c] = Σ_y wy[n, x, p, o, y]·f[n, y, x, c]
    tmp = torch.matmul(wy.reshape(n, w, p * s_y, h),
                       features.permute(0, 2, 1, 3))
    tmp = tmp.reshape(n, w, p, s_y, c).permute(0, 2, 3, 1, 4)
    # pass 2 (horizontal): out[n, p, o, a, c] = Σ_x wx[n, p, o, a, x]·tmp
    return torch.matmul(wx, tmp)


def _joint_group() -> int:
    """Parts per joint contraction group, forward (the kernel-placed
    fold's windowed warps) and backward (the joint transposed warp), from
    ``PT_WARP_JOINT_GROUP`` at each call: 0 (the default, and any value
    below 1) means all parts in one contraction. JAX's ``_joint_group``."""
    return max(0, int(os.environ.get("PT_WARP_JOINT_GROUP", "0") or 0))


def _warp_win_joint(features: torch.Tensor, warps: torch.Tensor,
                    y0: torch.Tensor, x0: torch.Tensor, s_y: int, s_x: int,
                    init_image_size: tuple[int, int]) -> torch.Tensor:
    """``_warp_win`` of all parts, or under ``PT_WARP_JOINT_GROUP`` one
    ``_warp_win`` per group of parts, concatenated on the part axis (JAX's
    ``_warp_batch_win_joint``)."""
    p = warps.shape[1]
    group = _joint_group() or p
    if group >= p:
        return _warp_win(features, warps, y0, x0, s_y, s_x, init_image_size)
    return torch.cat([
        _warp_win(features, warps[:, k:k + group], y0[:, k:k + group],
                  x0[:, k:k + group], s_y, s_x, init_image_size)
        for k in range(0, p, group)], dim=1)


def _warp_full(features: torch.Tensor, warps: torch.Tensor,
               init_image_size: tuple[int, int]) -> torch.Tensor:
    """Full-map two-pass warp by per-sample (N, 8) transforms."""
    n, h, w, _ = features.shape
    zero = torch.zeros((n, 1), dtype=torch.int64, device=features.device)
    return _warp_win(features, warps[:, None], zero, zero, h, w,
                     init_image_size)[:, 0]


def _warp_win_t(g_wins: torch.Tensor, warps: torch.Tensor,
                y0: torch.Tensor, x0: torch.Tensor, h: int, w: int,
                init_image_size: tuple[int, int],
                joint: bool) -> torch.Tensor:
    """Linear transpose of ``_warp_win``: (N, P, S_y, S_x, C) window
    cotangents → (N, H, W, C) feature gradient, summed over the parts.

    Same taps and weights, passes in reverse order: on the card the
    ``warp_taps_t`` kernel gathers them; on the CPU (and inside
    ``banded_warps``) the banded weights, contracted on the other sides
    (``_warp_win_t_banded``). Pass 1 rounds
    to the cotangents' dtype (f32 accumulate, one rounding). ``joint``:
    pass 2 contracts the (part, window row) axes together and returns f32
    — JAX's ``_warp_batch_t_win_joint``; its operands are upcast, which is
    exact for bf16 values, so the sum is the f32 accumulation of the bf16
    products; under ``PT_WARP_JOINT_GROUP``
    one such contraction per group of parts (``_joint_group``). Otherwise
    pass 2 rounds to the cotangents' dtype too (``warp_feature_matmul_t``).
    """
    p = g_wins.shape[1]
    group = _joint_group() if joint else 0
    if 0 < group < p:
        # PT_WARP_JOINT_GROUP: one joint contraction per group of parts,
        # the groups' f32 gradients added in group order, as JAX's
        # ``_warp_batch_t_win_joint``
        df = None
        for k in range(0, p, group):
            sl = slice(k, k + group)
            dfk = _warp_win_t(g_wins[:, sl], warps[:, sl], y0[:, sl],
                              x0[:, sl], h, w, init_image_size, joint=True)
            df = dfk if df is None else df + dfk
        return df
    if g_wins.is_cuda and not _banded_on_card:
        return warp_fused.warp_taps_t(
            g_wins.contiguous(),
            _tap_coeffs(warps, h, w, init_image_size, y0, x0), h, w, joint)
    return _warp_win_t_banded(g_wins, warps, y0, x0, h, w, init_image_size,
                              joint)


def _warp_win_t_banded(g_wins: torch.Tensor, warps: torch.Tensor,
                       y0: torch.Tensor, x0: torch.Tensor, h: int, w: int,
                       init_image_size: tuple[int, int],
                       joint: bool) -> torch.Tensor:
    """``_warp_win_t`` of one contraction as products by the transposed
    banded weights of ``_two_pass_weights``."""
    n, p, s_y, s_x, c = g_wins.shape
    wy, wx = _two_pass_weights(warps, h, w, init_image_size, g_wins.dtype,
                               y0, x0, s_y, s_x)
    # pass 1: dtmp[n, p, o, x, c] = Σ_a wx[n, p, o, a, x]·g[n, p, o, a, c]
    dtmp = torch.matmul(wx.transpose(-1, -2), g_wins)
    dtmp = dtmp.permute(0, 3, 1, 2, 4).reshape(n, w, p * s_y, c)
    # pass 2: df[n, y, x, c] = Σ_{p, o} wy[n, x, p, o, y]·dtmp[n, p, o, x, c]
    wyt = wy.reshape(n, w, p * s_y, h).transpose(-1, -2)
    if joint:
        wyt, dtmp = wyt.float(), dtmp.float()
    return torch.matmul(wyt, dtmp).permute(0, 2, 1, 3)


def _warp_full_t(g: torch.Tensor, warps: torch.Tensor,
                 init_image_size: tuple[int, int]) -> torch.Tensor:
    """Transpose of ``_warp_full`` by per-sample (N, 8) transforms, both
    passes rounded to g's dtype."""
    n, h, w, _ = g.shape
    zero = torch.zeros((n, 1), dtype=torch.int64, device=g.device)
    return _warp_win_t(g[:, None], warps[:, None], zero, zero, h, w,
                       init_image_size, joint=False)


def _support_windows(masks_r: torch.Tensor, s_y: int, s_x: int,
                     x_align: int = 1):
    """Window starts and flags from the resized masks' nonzero support.

    Args:
      masks_r: (N, T, h, w) nonnegative part masks at feature resolution.
      s_y, s_x: static window sizes.
      x_align: round x starts DOWN to this multiple; ``fits`` accounts for
        the rounding.

    Returns:
      y0, x0: (N, T) int64 window starts, clipped in-bounds.
      fits: (N, T) bool — the window covers the support (empty masks fit).
      empty: (N, T) bool — mask has no nonzero pixel.
    """
    n, t, h, w = masks_r.shape
    nz = masks_r > 0
    rows = nz.any(dim=3)                                   # (N, T, h)
    cols = nz.any(dim=2)                                   # (N, T, w)

    def first_last(flags, extent):
        idx = torch.arange(extent, device=flags.device)
        first = torch.where(flags, idx, extent).amin(dim=-1)
        last = torch.where(flags, idx, -1).amax(dim=-1)
        return first, last

    fy, ly = first_last(rows, h)
    fx, lx = first_last(cols, w)
    empty = ly < 0
    y0 = torch.where(empty, 0, fy).clamp(0, h - s_y)
    x0 = torch.where(empty, 0, fx)
    if x_align > 1:
        x0 = (x0 // x_align) * x_align
        x_max = ((w - s_x) // x_align) * x_align
    else:
        x_max = w - s_x
    x0 = x0.clamp(0, x_max)
    fits = ((ly <= y0 + s_y - 1) & (lx <= x0 + s_x - 1)) | empty
    return y0, x0, fits, empty


def _windowable(h: int, w: int) -> bool:
    """Even spatial dims and windows of at least 32 (the JAX package's
    gate: deeper stages take the full scan)."""
    return not (h % 2 or w % 2 or min(h // 2, w // 2) < 32)


def _fold_windows(masks_r, h: int, w: int, windowed: bool, x_align: int = 1,
                  sizes=None):
    """The ``_support_windows`` tuple when windowing applies (masks and a
    ``_windowable`` shape), else None; ``sizes`` overrides the (h//2, w//2)
    windows (the placement kernel widens s_x)."""
    if not windowed or masks_r is None or not _windowable(h, w):
        return None
    s_y, s_x = sizes if sizes is not None else (h // 2, w // 2)
    return _support_windows(masks_r, s_y, s_x, x_align)


def _kernel_window_sizes(h: int, w: int):
    """(s_y, s_x) of the placement kernel's windows, or None: s_x is
    widened by X_ALIGN so that an aligned start still covers any support
    of extent ≤ w//2."""
    xa = warp_fused.X_ALIGN
    if w % xa or (w // 2) % xa:
        return None
    return h // 2, min(w // 2 + xa, w)


def _place_actives(t: int, static_empty: tuple[int, ...]) -> tuple[int, ...]:
    """Fold order of the windowed (non-body) parts; idx stores these
    ORIGINAL part indices."""
    return tuple(i for i in range(1, t) if i not in static_empty)


PLACE_IMPLS = ("auto", "kernel", "xla")


def _use_place_kernel(place_impl, h, w, c, t, warp_agg, has_masks, windowed,
                      static_empty) -> bool:
    """Whether this fold instance may take the windowed, kernel-placed
    fold (before the data-dependent fit check); 'xla' never does."""
    if place_impl == "xla" or not windowed or not has_masks \
            or warp_agg != "max":
        return False
    if not _windowable(h, w):
        return False
    sizes = _kernel_window_sizes(h, w)
    return sizes is not None and warp_fused.supported(h, w, c, *sizes) \
        and bool(_place_actives(t, static_empty))


def _win_at(y0: torch.Tensor, x0: torch.Tensor, s_y: int, s_x: int):
    """Advanced index of the (N, P) windows of an (N, h, w[, C]) map:
    ``x[_win_at(...)]`` gathers (N, P, S_y, S_x[, C]) and assigning to it
    scatters back."""
    dev = y0.device
    rows = y0[..., None] + torch.arange(s_y, device=dev)     # (N, P, S_y)
    cols = x0[..., None] + torch.arange(s_x, device=dev)     # (N, P, S_x)
    ni = torch.arange(y0.shape[0], device=dev)[:, None, None, None]
    return ni, rows[..., :, None], cols[..., None, :]


def _slice_win(x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
               s_y: int, s_x: int) -> torch.Tensor:
    """Per-(sample, part) window slice: (N, P, h, w) maps with (N, P)
    starts → (N, P, S_y, S_x)."""
    n, p = y0.shape
    dev = x.device
    rows = y0[..., None] + torch.arange(s_y, device=dev)     # (N, P, S_y)
    cols = x0[..., None] + torch.arange(s_x, device=dev)     # (N, P, S_x)
    ni = torch.arange(n, device=dev)[:, None, None, None]
    pi = torch.arange(p, device=dev)[None, :, None, None]
    return x[ni, pi, rows[..., :, None], cols[..., None, :]]


def _fold_scan(features, warps, masks_r, init_image_size, warp_agg,
               static_empty=(), emit_idx=True):
    """Full-resolution fold over the T transforms → (out, idx).

    'max': strict ``>`` (earliest part wins ties), idx int8. With
    ``static_empty`` those parts are compacted out: idx stores COMPACTED
    positions, and their all-zero contribution joins as one final
    ``max(acc, 0)`` with idx -1. 'avg' divides by the FULL part count.
    idx is None for 'avg' and for ``emit_idx=False``.
    """
    n, h, w, c = features.shape
    t = warps.shape[1]
    active = [i for i in range(t) if i not in static_empty]
    if warp_agg == "max":
        acc = torch.full((n, h, w, c), float("-inf"), dtype=features.dtype,
                         device=features.device)
        idx = torch.zeros((n, h, w, c), dtype=torch.int8,
                          device=features.device) if emit_idx else None
        for k, i in enumerate(active):
            warped = _warp_full(features, warps[:, i], init_image_size)
            if masks_r is not None:
                warped = warped * masks_r[:, i][..., None]
            take = warped > acc
            acc = torch.where(take, warped, acc)
            if emit_idx:
                idx = torch.where(take, torch.full_like(idx, k), idx)
        if len(active) != t:
            take0 = acc < 0
            acc = torch.where(take0, torch.zeros((), dtype=acc.dtype,
                                                 device=acc.device), acc)
            if emit_idx:
                idx = torch.where(take0, torch.full_like(idx, -1), idx)
        return acc, idx

    acc = torch.zeros((n, h, w, c), dtype=torch.float32,
                      device=features.device)
    for i in active:
        warped = _warp_full(features, warps[:, i], init_image_size)
        if masks_r is not None:
            warped = warped * masks_r[:, i][..., None]
        acc = acc + warped.float()
    return (acc / t).to(features.dtype), None


def _place_offs(y0: torch.Tensor, x0: torch.Tensor, sel) -> torch.Tensor:
    """(N, P, 3) int32 [y0, x0, part_index] rows of the parts ``sel`` for
    the placement kernels, from (N, T) window starts."""
    ys, xs = y0[:, sel], x0[:, sel]
    parts = torch.tensor(sel, dtype=ys.dtype, device=ys.device)
    return torch.stack([ys, xs, parts.expand(ys.shape[0], -1)], dim=-1) \
        .to(torch.int32).contiguous()


def _place_args(masks_r, windows, h, w, t, static_empty):
    """The placed parts' shared inputs of ``fold_place`` and
    ``fold_route``: (sel, mwins, offs) — the active part indices, their
    (N, P, S_y, S_x) mask windows and (N, P, 3) int32 [y0, x0, part]."""
    y0, x0 = windows
    s_y, s_x = _kernel_window_sizes(h, w)
    sel = list(_place_actives(t, static_empty))
    mwins = _slice_win(masks_r[:, sel], y0[:, sel], x0[:, sel], s_y,
                       s_x).contiguous()
    return sel, mwins, _place_offs(y0, x0, sel)


def _place_batch_chunk(n, h, w, c, p, itemsize) -> int:
    """Samples per call of the kernel-placed windowed fold (JAX's
    ``_place_batch_chunk``, letter for letter).

    The fold's transient stacks grow with the batch. JAX's estimate per
    sample counts the joint pass-1 stack (P, S_y, W, C) and the wins stack
    (P, S_y, S_x, C): ``p·s_y·(w + s_x)·c·itemsize`` bytes. While the batch
    fits ``PT_WARP_PLACE_CHUNK_MB`` (default 3072; read at each call) it
    runs in one call, else in chunks of as many samples as fit, at least
    one (an empty value is the default; 0 and below give 1-sample chunks,
    as in JAX). On the card the warps' taps are computed in the kernels,
    with no weight matrices, so the estimate leaves nothing out there; the
    CPU's banded weights, which JAX fuses into its dots, are not in it.
    """
    s_y, s_x = _kernel_window_sizes(h, w)
    cap = int(os.environ.get("PT_WARP_PLACE_CHUNK_MB", "3072") or 3072)
    per_sample = p * s_y * (w + s_x) * c * itemsize
    if n * per_sample <= cap * 2**20:
        return n
    return max(1, min(n, (cap * 2**20) // per_sample))


def _batch_chunks(n: int, chunk: int) -> list[slice]:
    """``n // chunk`` full chunks in order, then one smaller call for the
    remainder (never a chunk shrunk to a divisor of n)."""
    return [slice(a, min(a + chunk, n)) for a in range(0, n, chunk)]


def _fold_windowed_place(features, warps, masks_r, init_image_size,
                         windows, static_empty=(), emit_idx=True):
    """Kernel-placed windowed max fold → (out, idx).

    The body (part 0) is warped at full resolution and pre-masked; every
    other active part only inside its window (one batched two-pass over
    the parts, or one per ``PT_WARP_JOINT_GROUP`` group); ``fold_place``
    does the placement, mask multiply, max / argmax and the zero pass. idx
    stores ORIGINAL part indices. A batch over ``_place_batch_chunk`` runs
    chunk by chunk, one ``fold_place`` launch each: every sample's fold is
    independent, so only the chunk's transients are alive at a time.
    """
    n, h, w, c = features.shape
    p = len(_place_actives(warps.shape[1], static_empty))
    chunk = _place_batch_chunk(n, h, w, c, p, features.element_size())
    if chunk >= n:
        return _fold_windowed_place_chunk(features, warps, masks_r,
                                          init_image_size, windows,
                                          static_empty, emit_idx)
    y0, x0 = windows
    out = torch.empty_like(features)
    idx = torch.empty(features.shape, dtype=torch.int8,
                      device=features.device) if emit_idx else None
    for sl in _batch_chunks(n, chunk):
        o, i = _fold_windowed_place_chunk(
            features[sl], warps[sl], masks_r[sl], init_image_size,
            (y0[sl], x0[sl]), static_empty, emit_idx)
        out[sl] = o
        if emit_idx:
            idx[sl] = i
    return out, idx


def _fold_windowed_place_chunk(features, warps, masks_r, init_image_size,
                               windows, static_empty, emit_idx):
    """``_fold_windowed_place`` on one call's samples."""
    n, h, w, c = features.shape
    t = warps.shape[1]
    y0, x0 = windows
    s_y, s_x = _kernel_window_sizes(h, w)
    sel, mwins, offs = _place_args(masks_r, windows, h, w, t, static_empty)

    body = _warp_full(features, warps[:, 0], init_image_size)
    body = body * masks_r[:, 0][..., None]
    wins = _warp_win_joint(features, warps[:, sel], y0[:, sel], x0[:, sel],
                           s_y, s_x, init_image_size)
    if static_empty:
        # a statically-empty part contributes zero at EVERY pixel
        zero_nb = torch.ones((n, h, w), dtype=torch.bool,
                             device=features.device)
    else:
        zero_nb = (masks_r[:, 1:] == 0).any(dim=1)
    return warp_fused.fold_place(body.contiguous(), wins.contiguous(), mwins,
                                 zero_nb.contiguous(), offs, emit_idx)


def _fold_windowed_place_bwd(g, warps, masks_r, idx, init_image_size,
                             windows, static_empty=()):
    """Backward of ``_fold_windowed_place`` → f32 feature gradient, in the
    forward's chunks (``_place_batch_chunk`` re-derived from g's dtype, as
    in JAX), one ``fold_route`` launch each."""
    n, h, w, c = g.shape
    p = len(_place_actives(warps.shape[1], static_empty))
    chunk = _place_batch_chunk(n, h, w, c, p, g.element_size())
    if chunk >= n:
        return _fold_windowed_place_bwd_chunk(g, warps, masks_r, idx,
                                              init_image_size, windows,
                                              static_empty)
    y0, x0 = windows
    df = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    for sl in _batch_chunks(n, chunk):
        df[sl] = _fold_windowed_place_bwd_chunk(
            g[sl], warps[sl], masks_r[sl], idx[sl], init_image_size,
            (y0[sl], x0[sl]), static_empty)
    return df


def _fold_windowed_place_bwd_chunk(g, warps, masks_r, idx, init_image_size,
                                   windows, static_empty):
    """``_fold_windowed_place_bwd`` on one call's samples.

    The mask windows and offsets are rebuilt from the saved masks and
    window starts (small); ``fold_route`` routes the cotangent to the
    winning part (times its mask) as window stacks and a body route; the
    body route goes through the full-map transposed warp (rounded to g's
    dtype, then f32), the windows through the joint transposed warp over
    the parts (f32).
    """
    _, h, w, _ = g.shape
    y0, x0 = windows
    sel, mwins, offs = _place_args(masks_r, windows, h, w, warps.shape[1],
                                   static_empty)
    gwins, gbody = warp_fused.fold_route(g, idx, masks_r[:, 0].contiguous(),
                                         mwins, offs)
    df0 = _warp_full_t(gbody, warps[:, 0], init_image_size).float()
    dfp = _warp_win_t(gwins, warps[:, sel], y0[:, sel], x0[:, sel], h, w,
                      init_image_size, joint=True)
    return df0 + dfp


def _fold_windowed(features, warps, masks_r, init_image_size, warp_agg,
                   windows, static_empty=(), emit_idx=True):
    """Windowed fold with XLA-style placement → (out, idx).

    The body (part 0, masked) at full resolution; every other active part
    only inside its (h/2, w/2) window, warped on its own, masked, and
    placed in fold order: its window of the running max is gathered,
    compared (strict ``>``: the earliest part keeps ties) and scattered
    back, batched over the samples. 'max': a final zero pass where some
    non-body part contributes an exact zero (every pixel under
    ``static_empty``) and the max is negative, idx -1 there; idx int8 holds
    ORIGINAL part indices. 'avg': an f32 sum of the masked windows, divided
    by the FULL part count; idx None.
    """
    n, h, w, c = features.shape
    t = warps.shape[1]
    y0, x0 = windows
    s_y, s_x = h // 2, w // 2
    sel = _place_actives(t, static_empty)
    body = _warp_full(features, warps[:, 0], init_image_size) \
        * masks_r[:, 0][..., None]
    if warp_agg == "max":
        acc = body
        idx = torch.zeros(acc.shape, dtype=torch.int8,
                          device=acc.device) if emit_idx else None
    else:
        acc = body.float()
        idx = None
    for i in sel:
        yi, xi = y0[:, i:i + 1], x0[:, i:i + 1]
        win = _warp_win(features, warps[:, i:i + 1], yi, xi, s_y, s_x,
                        init_image_size)
        win = win * _slice_win(masks_r[:, i:i + 1], yi, xi, s_y,
                               s_x)[..., None]
        at = _win_at(yi, xi, s_y, s_x)
        cur = acc[at]
        if warp_agg != "max":
            acc[at] = cur + win.float()
            continue
        take = win > cur
        acc[at] = torch.where(take, win, cur)
        if emit_idx:
            idx[at] = torch.where(take, torch.full_like(idx[at], i), idx[at])
    if warp_agg != "max":
        return (acc / t).to(features.dtype), None
    if static_empty:
        # a statically-empty part contributes zero at EVERY pixel
        zero_exists = torch.ones((n, h, w), dtype=torch.bool,
                                 device=acc.device)
    else:
        zero_exists = (masks_r[:, 1:] == 0).any(dim=1)
    take0 = zero_exists[..., None] & (acc < 0)
    acc = acc.masked_fill(take0, 0)
    if emit_idx:
        idx.masked_fill_(take0, -1)
    return acc, idx


def _fold_windowed_bwd(g, warps, masks_r, idx, init_image_size, warp_agg,
                       windows, static_empty=()):
    """Backward of ``_fold_windowed`` → f32 feature gradient: the body's
    cotangent (g where idx is 0 for 'max', g/T for 'avg', times its mask)
    through the full-map transposed warp; each active part's window of the
    cotangent (g where idx is its ORIGINAL index, or g/T, times its mask
    window) through one joint transposed warp over the parts."""
    _, h, w, _ = g.shape
    t = warps.shape[1]
    y0, x0 = windows
    s_y, s_x = h // 2, w // 2
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    gm0 = torch.where(idx == 0, g, zero) if warp_agg == "max" else g / t
    df0 = _warp_full_t(gm0 * masks_r[:, 0][..., None], warps[:, 0],
                       init_image_size).float()
    sel = list(_place_actives(t, static_empty))
    if not sel:
        return df0
    ys, xs = y0[:, sel], x0[:, sel]
    at = _win_at(ys, xs, s_y, s_x)
    if warp_agg == "max":
        parts = torch.tensor(sel, dtype=idx.dtype, device=g.device)
        gm = torch.where(idx[at] == parts[:, None, None, None], g[at], zero)
    else:
        gm = g[at] / t
    gm = gm * _slice_win(masks_r[:, sel], ys, xs, s_y, s_x)[..., None]
    return df0 + _warp_win_t(gm, warps[:, sel], ys, xs, h, w,
                             init_image_size, joint=True)


def _fold_scan_bwd(g, warps, masks_r, idx, init_image_size, warp_agg,
                   static_empty=()):
    """Backward of ``_fold_scan`` → f32 feature gradient: each active
    part's cotangent (g where idx is its COMPACTED position for 'max', g/T
    for 'avg'), times its mask, transpose-warped in g's dtype and summed in
    f32."""
    t = warps.shape[1]
    active = [i for i in range(t) if i not in static_empty]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    df = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    for k, i in enumerate(active):
        gm = torch.where(idx == k, g, zero) if warp_agg == "max" else g / t
        if masks_r is not None:
            gm = gm * masks_r[:, i][..., None]
        df += _warp_full_t(gm, warps[:, i], init_image_size).float()
    return df


@dataclasses.dataclass
class FoldPlan:
    """One fold instance's inputs that depend only on the masks: the
    resized masks and, when the windowed fold applies, its window starts
    and placement."""
    masks_r: torch.Tensor | None
    windows: tuple[torch.Tensor, torch.Tensor] | None = None
    fits: bool = False
    pallas: bool = False       # the fused two-pass warp fold
    xla: bool = False          # windows placed by _fold_windowed
    exact: bool = False        # the gather-bilinear fold, _fold_exact

    @property
    def branch(self) -> str:
        """The fold this instance takes: 'exact', 'pallas' (the fused
        warp fold), 'place' or 'xla' (the windowed fold, kernel- or
        XLA-style placed), 'fallback' (windowable, but a part outgrew its
        window: the full scan, counted in ``COUNTS['scan_fallback']``) or
        'scan' (the full scan)."""
        if self.exact:
            return "exact"
        if self.pallas:
            return "pallas"
        if self.windows is None:
            return "scan"
        if not self.fits:
            return "fallback"
        return "xla" if self.xla else "place"


def check_place(place_impl: str) -> None:
    """Raise on an unknown windowed placement."""
    if place_impl not in PLACE_IMPLS:
        raise ValueError(f"invalid place_impl {place_impl!r}; one of "
                         f"{PLACE_IMPLS}")


def check_backend(backend: str) -> None:
    """Raise on an unknown warp backend."""
    if backend not in BACKENDS:
        raise ValueError(f"invalid warp backend {backend!r}; one of "
                         f"{BACKENDS}")


def plan_folds(shapes, warps: torch.Tensor, masks: torch.Tensor | None,
               dtype: torch.dtype, warp_skip: str = "mask",
               warp_agg: str = "max", windowed: bool = False,
               static_empty: tuple[int, ...] = (),
               backend: str = "matmul",
               place_impl: str = "auto") -> list[FoldPlan]:
    """Plan the fold instances of one forward, one per (N, h, w, C) shape.

    Resizes the masks for every instance, marks the instances that take the
    fused warp fold (``backend='pallas'``: a supported shape and a max
    fold; they need no windows) or the gather-bilinear fold
    (``backend='exact'``: every instance, no windows), computes every
    other windowed instance's support windows for its placement
    (``place_impl``: the kernel's widened, aligned windows, or the (h/2,
    w/2) ones of the XLA-style placement), and
    resolves all 'does every non-body part fit its window?' flags with ONE
    host sync. A fold whose parts do not all fit takes the full scan, where
    the JAX package's ``lax.cond`` takes it.
    """
    with span("fold.plan", instances=len(shapes)):
        check_backend(backend)
        check_place(place_impl)
        plans, pending = [], []
        t = warps.shape[1]
        for n, h, w, c in shapes:
            if warp_skip == "mask":
                if masks is None:
                    raise ValueError("warp_skip='mask' requires part masks")
                masks_r = resize_bilinear(masks.to(dtype), (h, w))
            else:
                masks_r = None
            plan = FoldPlan(masks_r)
            if backend == "exact":
                plan.exact = True
            elif backend == "pallas" and warp_agg == "max" \
                    and warp_pallas.supported(h, w):
                plan.pallas = True
            else:
                kernel = _use_place_kernel(place_impl, h, w, c, t, warp_agg,
                                           masks_r is not None, windowed,
                                           static_empty)
                windows = _fold_windows(masks_r, h, w, windowed,
                                        warp_fused.X_ALIGN,
                                        _kernel_window_sizes(h, w)) if kernel \
                    else _fold_windows(masks_r, h, w, windowed)
                if windows is not None:
                    y0, x0, fits, _ = windows
                    plan.windows, plan.xla = (y0, x0), not kernel
                    pending.append((plan, fits[:, 1:].all()))
            plans.append(plan)
        if pending:
            flags = torch.stack([f for _, f in pending])
            with span("fold.plan_sync"):
                flags = flags.tolist()
            for (plan, _), ok in zip(pending, flags):
                plan.fits = bool(ok)
        return plans


def _pallas_args(features, warps, masks_r, init_image_size):
    """The fused fold's contiguous features, (N, T, 8) f32 transforms and
    (N, T, h, w) masks. The translations are scaled in f32 after the cast,
    as in the JAX package's Pallas branch (the matmul branch scales in the
    warps' dtype); unmasked warping folds under all-ones masks."""
    n, h, w, _ = features.shape
    t = warps.shape[1]
    scale = torch.tensor([1.0, 1.0, w / init_image_size[1], 1.0, 1.0,
                          h / init_image_size[0], 1.0, 1.0],
                         dtype=torch.float32, device=warps.device)
    warps_scaled = (warps.float() * scale).contiguous()
    if masks_r is None:
        masks_r = torch.ones((n, t, h, w), dtype=features.dtype,
                             device=features.device)
    return features.contiguous(), warps_scaled, masks_r.contiguous()


def _fold(features, warps, plan, init_image_size, warp_agg, static_empty,
          emit_idx):
    """The fold on the branch ``plan`` chose → (out, idx)."""
    branch = plan.branch
    if branch == "exact":
        return _fold_exact(features, warps, plan.masks_r, init_image_size,
                           warp_agg), None
    if branch == "pallas":
        return warp_pallas.warp_fold(
            *_pallas_args(features, warps, plan.masks_r, init_image_size),
            emit_idx)
    if branch == "xla":
        return _fold_windowed(features, warps, plan.masks_r,
                              init_image_size, warp_agg, plan.windows,
                              static_empty, emit_idx)
    if branch == "place":
        return _fold_windowed_place(features, warps, plan.masks_r,
                                    init_image_size, plan.windows,
                                    static_empty, emit_idx)
    if branch == "fallback":
        COUNTS["scan_fallback"] += 1
    return _fold_scan(features, warps, plan.masks_r, init_image_size,
                      warp_agg, static_empty, emit_idx)


class WarpFold(torch.autograd.Function):
    """The fold as an autograd Function: forward on the branch its
    ``FoldPlan`` chose, with the argmax; backward routes the cotangent
    through it (JAX: ``warp_fold_matmul``'s ``_fold_fwd``/``_fold_bwd``).

    Saved: warps, resized masks, the argmax (int8, feature-shaped) and the
    window starts — no feature maps, no banded weights. Gradient: features
    only; warps and masks are host data and get none.
    """

    @staticmethod
    def forward(ctx, features, warps, plan, init_image_size, warp_agg,
                static_empty):
        out, idx = _fold(features, warps, plan, init_image_size, warp_agg,
                         static_empty, emit_idx=True)
        y0, x0 = plan.windows or (None, None)
        ctx.save_for_backward(warps, plan.masks_r, idx, y0, x0)
        ctx.branch = plan.branch
        ctx.args = (init_image_size, warp_agg, static_empty)
        return out

    @staticmethod
    def backward(ctx, g):
        warps, masks_r, idx, y0, x0 = ctx.saved_tensors
        init_image_size, warp_agg, static_empty = ctx.args
        # g reaches here through NCHW views and channel slices: the router
        # kernel takes a contiguous, 16-byte aligned map
        if not g.is_contiguous() or g.data_ptr() % 16:
            g = g.clone(memory_format=torch.contiguous_format)
        with span(f"fold.bwd.{g.shape[1]}x{g.shape[2]}", branch=ctx.branch):
            if ctx.branch == "xla":
                df = _fold_windowed_bwd(g, warps, masks_r, idx,
                                        init_image_size, warp_agg, (y0, x0),
                                        static_empty)
            elif ctx.branch == "place":
                df = _fold_windowed_place_bwd(g, warps, masks_r, idx,
                                              init_image_size, (y0, x0),
                                              static_empty)
            else:
                df = _fold_scan_bwd(g, warps, masks_r, idx, init_image_size,
                                    warp_agg, static_empty)
            return df.to(g.dtype), None, None, None, None, None


def affine_transform_layer(features: torch.Tensor, warps: torch.Tensor,
                           masks: torch.Tensor | None,
                           init_image_size: tuple[int, int],
                           warp_skip: str = "mask",
                           warp_agg: str = "max",
                           windowed: bool = False,
                           static_empty: tuple[int, ...] = (),
                           plan: FoldPlan | None = None,
                           backend: str = "matmul",
                           place_impl: str = "auto") -> torch.Tensor:
    """Warp + (mask) + aggregate over the T part transforms.

    Differentiable in ``features`` (``WarpFold``, or ``WarpFoldPallas`` on
    the fused branch, or the 'exact' fold under ``torch.utils.checkpoint``)
    when grad mode is on and they require grad; otherwise the forward alone
    runs, without the argmax (serving and the discriminator phase's
    generator forward).

    Args:
      features: (N, h, w, C) NHWC appearance skip.
      warps: (N, T, 8) inverse pixel affines estimated at
        ``init_image_size``, in the compute dtype.
      masks: (N, T, H0, W0) part masks at image resolution (required for
        ``warp_skip='mask'``, ignored otherwise).
      warp_skip: 'mask' | 'full' | 'none' ('none' still warps, unmasked).
      warp_agg: 'max' or 'avg'.
      windowed: take a windowed fold where the shape qualifies and every
        part's support fits its window.
      static_empty: part indices that are empty for every input (the
        fused branch folds every part, as in the JAX package).
      plan: this instance's ``plan_folds`` entry (computed here if None).
      backend: 'matmul', 'pallas' or 'exact' (read only when ``plan`` is
        None).
      place_impl: the windowed placement, 'auto', 'kernel' or 'xla' (read
        only when ``plan`` is None).

    Returns:
      (N, h, w, C) aggregated warped features.
    """
    if plan is None:
        plan = plan_folds([tuple(features.shape)], warps, masks,
                          features.dtype, warp_skip, warp_agg, windowed,
                          static_empty, backend, place_impl)[0]
    _, h, w, _ = features.shape
    with span(f"fold.fwd.{h}x{w}", branch=plan.branch):
        if torch.is_grad_enabled() and features.requires_grad:
            if plan.exact:
                # recomputed in the backward: autograd would otherwise keep
                # every part's gathered taps
                return torch.utils.checkpoint.checkpoint(
                    _fold_exact, features, warps, plan.masks_r,
                    init_image_size, warp_agg, use_reentrant=False)
            if plan.pallas:
                return warp_pallas.WarpFoldPallas.apply(*_pallas_args(
                    features, warps, plan.masks_r, init_image_size))
            return WarpFold.apply(features, warps, plan, init_image_size,
                                  warp_agg, static_empty)
        return _fold(features, warps, plan, init_image_size, warp_agg,
                     static_empty, emit_idx=False)[0]
