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

Each fold instance takes one of six branches. ``plan_folds`` decides it
once, with the instance's windows, batch chunk and part group, and records
them in the instance's ``FoldPlan``; ``apply_plan`` runs an instance on
its plan, and ``_BRANCHES`` runs each branch forward, backward and under
autograd:
- 'scan' (``_fold_scan``): every part warped at full resolution, folded in
  order with strict ``>`` (earliest part wins ties);
- 'place' (``_fold_windowed_place``): the body at full resolution, every
  other part only inside its mask's bounding-box window, placed by
  ``ops.warp_fused.fold_place``. Exact: outside its window a part's masked
  contribution is zero, which the zero pass restores;
- 'xla' (``_fold_windowed``, the JAX package's ``place_impl='xla'``): the
  same windows, (h/2, w/2) and unaligned, placed part by part by a gather,
  compare and scatter in plain PyTorch; the only windowed fold for
  ``warp_agg='avg'``;
- 'fallback': windowable, but some part's support outgrew its window: the
  full scan, where the JAX package's ``lax.cond`` takes it (``COUNTS``);
- 'pallas' and 'exact': the other two backends, below.
The placement is 'xla' (always the gather/scatter one) or 'auto' /
'kernel', one value here (``kernel_places``): the placement kernel where
the shape qualifies. (The JAX package's 'auto' takes the kernel only on a
TPU; the port's kernel runs wherever the fold runs.) Whether every part
fits its window is resolved for all fold instances of a forward with one
host sync.

The backward (``WarpFold``, the counterpart of ``warp_fold_matmul``'s custom
VJP) saves no feature maps: the warp is linear in the features, so it
routes the cotangent through the argmax and the transposed two-pass warps,
recomputing their taps ('place' routes with the ``fold_route`` kernel);
warps and masks get no gradient (host data).

``backend='pallas'`` sends every max fold instance whose shape passes
``warp_pallas.supported`` to the fused two-pass warp fold of
``ops/warp_pallas.py`` (``WarpFoldPallas``); the others take the branches
above, as in the JAX package (``warp.py:1282-1293``). ``backend='exact'``
warps each part directly (``warp_feature_single``: four bilinear taps
gathered at the transformed position, ``grid_sample`` semantics with zero
padding), folds in part order by ``torch.maximum`` (or sums for 'avg') and
recomputes in the backward (``torch.utils.checkpoint``, as the JAX
package's ``jax.checkpoint``); it plans no windows and launches no kernel.

Spans (``utils.spans``, while a profiler records): ``fold.plan`` around
``plan_folds`` with ``fold.plan_sync`` around its one host sync;
``fold.fwd.<h>x<w>`` around each fold instance's forward and
``fold.bwd.<h>x<w>`` around ``WarpFold``'s backward, both with the
instance's ``FoldPlan.branch``.

Two environment variables bound the windowed folds' memory, as in the JAX
package (``warp.py:436-553``, ``:870-1018``). They are read when a fold
instance is planned (the JAX package reads them when it traces), and its
forward and backward take them from the plan:
- ``PT_WARP_PLACE_CHUNK_MB`` (default 3072): 'place' runs the batch in
  chunks of ``_place_batch_chunk`` samples (``FoldPlan.chunk``);
- ``PT_WARP_JOINT_GROUP`` (default 0, no grouping): the windowed warps run
  in groups of that many parts, forward ('place') and backward ('place'
  and 'xla') (``FoldPlan.group``).

Transforms are (T, 8) row-major first-8 of a 3×3 matrix acting on (x, y, 1),
estimated at ``init_image_size``; translations are rescaled per feature
resolution.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import typing

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


def _fold_exact(features, warps, plan, init_image_size):
    """The 'exact' fold: every part warped by
    ``warp_feature_single``, masked, and folded in part order by
    ``torch.maximum`` from -inf (a tie splits the cotangent in half, as
    ``jnp.maximum``'s does) or summed in the features' dtype and divided by
    the part count."""
    n, h, w, c = features.shape
    t = warps.shape[1]
    is_max = plan.warp_agg == "max"
    acc = torch.full((n, h, w, c), float("-inf") if is_max else 0.0,
                     dtype=features.dtype, device=features.device)
    for i in range(t):
        warped = warp_feature_single(features, warps[:, i], init_image_size)
        if plan.masks_r is not None:
            warped = warped * plan.masks_r[:, i][..., None]
        acc = torch.maximum(acc, warped) if is_max else acc + warped
    return acc if is_max else acc / t


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
    ``banded_warps``. This is the one place that chooses between them.
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
    ``PT_WARP_JOINT_GROUP``, read when a fold instance is planned: 0 (the
    default, and any value below 1) means all parts in one contraction.
    JAX's ``_joint_group``."""
    return max(0, int(os.environ.get("PT_WARP_JOINT_GROUP", "0") or 0))


def _part_groups(p: int, group: int) -> list[slice]:
    """The part slices of a joint warp: all P parts, or groups of
    ``group`` parts (``FoldPlan.group``, JAX's ``_joint_group``)."""
    return _batch_chunks(p, group) if 0 < group < p else [slice(0, p)]


def _warp_win_joint(features: torch.Tensor, warps: torch.Tensor,
                    y0: torch.Tensor, x0: torch.Tensor, s_y: int, s_x: int,
                    init_image_size: tuple[int, int],
                    group: int) -> torch.Tensor:
    """``_warp_win`` of each part group, concatenated on the part axis
    (JAX's ``_warp_batch_win_joint``)."""
    wins = [_warp_win(features, warps[:, s], y0[:, s], x0[:, s], s_y, s_x,
                      init_image_size)
            for s in _part_groups(warps.shape[1], group)]
    return wins[0] if len(wins) == 1 else torch.cat(wins, dim=1)


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
    (``_warp_win_t_banded``). Pass 1 rounds to the cotangents' dtype (f32
    accumulate, one rounding). ``joint``: pass 2 contracts the (part,
    window row) axes together and returns f32 — JAX's
    ``_warp_batch_t_win_joint``; its operands are upcast, which is exact
    for bf16 values, so the sum is the f32 accumulation of the bf16
    products. Otherwise pass 2 rounds to the cotangents' dtype too
    (``warp_feature_matmul_t``).
    """
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
    """``_warp_win_t`` as products by the transposed banded weights of
    ``_two_pass_weights``."""
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


def _warp_win_t_joint(g_wins: torch.Tensor, warps: torch.Tensor,
                      y0: torch.Tensor, x0: torch.Tensor, h: int, w: int,
                      init_image_size: tuple[int, int],
                      group: int) -> torch.Tensor:
    """``_warp_win_t(joint=True)`` of each part group, the groups' f32
    gradients added in group order (JAX's ``_warp_batch_t_win_joint``)."""
    df = None
    for s in _part_groups(g_wins.shape[1], group):
        dfs = _warp_win_t(g_wins[:, s], warps[:, s], y0[:, s], x0[:, s], h,
                          w, init_image_size, joint=True)
        df = dfs if df is None else df + dfs
    return df


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


def _place_args(plan, t):
    """The placed parts' shared inputs of ``fold_place`` and
    ``fold_route`` for a 'place' plan of T parts: (sel, mwins, offs) — the
    active part indices, their (N, P, S_y, S_x) mask windows and (N, P, 3)
    int32 [y0, x0, part]."""
    y0, x0 = plan.windows
    sel = list(_place_actives(t, plan.static_empty))
    mwins = _slice_win(plan.masks_r[:, sel], y0[:, sel], x0[:, sel],
                       *plan.sizes).contiguous()
    return sel, mwins, _place_offs(y0, x0, sel)


def _place_batch_chunk(n, h, w, c, p, itemsize) -> int:
    """Samples per call of the kernel-placed windowed fold (JAX's
    ``_place_batch_chunk``, letter for letter).

    The fold's transient stacks grow with the batch. JAX's estimate per
    sample counts the joint pass-1 stack (P, S_y, W, C) and the wins stack
    (P, S_y, S_x, C): ``p·s_y·(w + s_x)·c·itemsize`` bytes. While the batch
    fits ``PT_WARP_PLACE_CHUNK_MB`` (default 3072; read when a fold
    instance is planned) it runs in one call, else in chunks of as many
    samples as fit, at least one (an empty value is the default; 0 and
    below give 1-sample chunks, as in JAX). On the card the warps' taps are
    computed in the kernels, with no weight matrices, so the estimate
    leaves nothing out there; the CPU's banded weights, which JAX fuses
    into its dots, are not in it.
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


def _zero_nb(plan, n, h, w) -> torch.Tensor:
    """(N, h, w) bool: some non-body part contributes an exact zero (at
    EVERY pixel where a part is statically empty), for the zero pass."""
    if plan.static_empty:
        return torch.ones((n, h, w), dtype=torch.bool,
                          device=plan.masks_r.device)
    return (plan.masks_r[:, 1:] == 0).any(dim=1)


def _fold_windowed_place(features, warps, plan, init_image_size,
                         emit_idx=True):
    """Kernel-placed windowed max fold of a 'place' plan → (out, idx).

    The body (part 0) is warped at full resolution and pre-masked; every
    other active part only inside its window (one batched two-pass over
    the parts, or one per part group, ``plan.group``); ``fold_place`` does
    the placement, mask multiply, max / argmax and the zero pass. idx
    stores ORIGINAL part indices. A batch over ``plan.chunk`` samples runs
    chunk by chunk, one ``fold_place`` launch each: every sample's fold is
    independent, so only the chunk's transients are alive at a time.
    """
    n = features.shape[0]
    if plan.chunk >= n:
        return _fold_windowed_place_chunk(features, warps, plan,
                                          init_image_size, emit_idx)
    out = torch.empty_like(features)
    idx = torch.empty(features.shape, dtype=torch.int8,
                      device=features.device) if emit_idx else None
    for sl in _batch_chunks(n, plan.chunk):
        o, i = _fold_windowed_place_chunk(features[sl], warps[sl],
                                          plan.samples(sl), init_image_size,
                                          emit_idx)
        out[sl] = o
        if emit_idx:
            idx[sl] = i
    return out, idx


def _fold_windowed_place_chunk(features, warps, plan, init_image_size,
                               emit_idx):
    """``_fold_windowed_place`` on one call's samples."""
    n, h, w, _ = features.shape
    masks_r, (y0, x0) = plan.masks_r, plan.windows
    sel, mwins, offs = _place_args(plan, warps.shape[1])
    body = _warp_full(features, warps[:, 0], init_image_size)
    body = body * masks_r[:, 0][..., None]
    wins = _warp_win_joint(features, warps[:, sel], y0[:, sel], x0[:, sel],
                           *plan.sizes, init_image_size, plan.group)
    return warp_fused.fold_place(body.contiguous(), wins.contiguous(), mwins,
                                 _zero_nb(plan, n, h, w).contiguous(), offs,
                                 emit_idx)


def _fold_windowed_place_bwd(g, warps, idx, plan, init_image_size):
    """Backward of ``_fold_windowed_place`` → f32 feature gradient, in the
    forward's chunks (``plan.chunk``), one ``fold_route`` launch each."""
    n = g.shape[0]
    if plan.chunk >= n:
        return _fold_windowed_place_bwd_chunk(g, warps, idx, plan,
                                              init_image_size)
    df = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    for sl in _batch_chunks(n, plan.chunk):
        df[sl] = _fold_windowed_place_bwd_chunk(
            g[sl], warps[sl], idx[sl], plan.samples(sl), init_image_size)
    return df


def _fold_windowed_place_bwd_chunk(g, warps, idx, plan, init_image_size):
    """``_fold_windowed_place_bwd`` on one call's samples.

    The mask windows and offsets are rebuilt from the saved masks and
    window starts (small); ``fold_route`` routes the cotangent to the
    winning part (times its mask) as window stacks and a body route; the
    body route goes through the full-map transposed warp (rounded to g's
    dtype, then f32), the windows through the joint transposed warp over
    the parts (f32).
    """
    _, h, w, _ = g.shape
    y0, x0 = plan.windows
    sel, mwins, offs = _place_args(plan, warps.shape[1])
    gwins, gbody = warp_fused.fold_route(
        g, idx, plan.masks_r[:, 0].contiguous(), mwins, offs)
    df0 = _warp_full_t(gbody, warps[:, 0], init_image_size).float()
    return df0 + _warp_win_t_joint(gwins, warps[:, sel], y0[:, sel],
                                   x0[:, sel], h, w, init_image_size,
                                   plan.group)


def _fold_windowed(features, warps, plan, init_image_size, emit_idx=True):
    """Windowed fold with XLA-style placement of an 'xla' plan → (out,
    idx).

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
    masks_r, (y0, x0), (s_y, s_x) = plan.masks_r, plan.windows, plan.sizes
    body = _warp_full(features, warps[:, 0], init_image_size) \
        * masks_r[:, 0][..., None]
    is_max = plan.warp_agg == "max"
    if is_max:
        acc = body
        idx = torch.zeros(acc.shape, dtype=torch.int8,
                          device=acc.device) if emit_idx else None
    else:
        acc = body.float()
        idx = None
    for i in _place_actives(t, plan.static_empty):
        yi, xi = y0[:, i:i + 1], x0[:, i:i + 1]
        win = _warp_win(features, warps[:, i:i + 1], yi, xi, s_y, s_x,
                        init_image_size)
        win = win * _slice_win(masks_r[:, i:i + 1], yi, xi, s_y,
                               s_x)[..., None]
        at = _win_at(yi, xi, s_y, s_x)
        cur = acc[at]
        if not is_max:
            acc[at] = cur + win.float()
            continue
        take = win > cur
        acc[at] = torch.where(take, win, cur)
        if emit_idx:
            idx[at] = torch.where(take, torch.full_like(idx[at], i), idx[at])
    if not is_max:
        return (acc / t).to(features.dtype), None
    take0 = _zero_nb(plan, n, h, w)[..., None] & (acc < 0)
    acc = acc.masked_fill(take0, 0)
    if emit_idx:
        idx.masked_fill_(take0, -1)
    return acc, idx


def _fold_windowed_bwd(g, warps, idx, plan, init_image_size):
    """Backward of ``_fold_windowed`` → f32 feature gradient: the body's
    cotangent (g where idx is 0 for 'max', g/T for 'avg', times its mask)
    through the full-map transposed warp; each active part's window of the
    cotangent (g where idx is its ORIGINAL index, or g/T, times its mask
    window) through one joint transposed warp over the parts (or one per
    part group, ``plan.group``)."""
    _, h, w, _ = g.shape
    t = warps.shape[1]
    masks_r, (y0, x0), (s_y, s_x) = plan.masks_r, plan.windows, plan.sizes
    is_max = plan.warp_agg == "max"
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    gm0 = torch.where(idx == 0, g, zero) if is_max else g / t
    df0 = _warp_full_t(gm0 * masks_r[:, 0][..., None], warps[:, 0],
                       init_image_size).float()
    sel = list(_place_actives(t, plan.static_empty))
    if not sel:
        return df0
    ys, xs = y0[:, sel], x0[:, sel]
    at = _win_at(ys, xs, s_y, s_x)
    if is_max:
        parts = torch.tensor(sel, dtype=idx.dtype, device=g.device)
        gm = torch.where(idx[at] == parts[:, None, None, None], g[at], zero)
    else:
        gm = g[at] / t
    gm = gm * _slice_win(masks_r[:, sel], ys, xs, s_y, s_x)[..., None]
    return df0 + _warp_win_t_joint(gm, warps[:, sel], ys, xs, h, w,
                                   init_image_size, plan.group)


def _fold_scan_bwd(g, warps, idx, plan, init_image_size):
    """Backward of ``_fold_scan`` → f32 feature gradient: each active
    part's cotangent (g where idx is its COMPACTED position for 'max', g/T
    for 'avg'), times its mask, transpose-warped in g's dtype and summed in
    f32."""
    t = warps.shape[1]
    active = [i for i in range(t) if i not in plan.static_empty]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    df = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    for k, i in enumerate(active):
        gm = torch.where(idx == k, g, zero) if plan.warp_agg == "max" \
            else g / t
        if plan.masks_r is not None:
            gm = gm * plan.masks_r[:, i][..., None]
        df += _warp_full_t(gm, warps[:, i], init_image_size).float()
    return df


@dataclasses.dataclass
class FoldPlan:
    """Every decision about one fold instance, made once by
    ``plan_folds``: the resized masks, the aggregation and static-empty
    parts, the ``branch`` ('place', 'xla', 'scan', 'fallback', 'pallas' or
    'exact', see the module's docstring) and, for the windowed branches,
    the window starts and sizes, the part group (``PT_WARP_JOINT_GROUP``)
    and for 'place' the batch chunk (``PT_WARP_PLACE_CHUNK_MB``)."""
    masks_r: torch.Tensor | None
    warp_agg: str = "max"
    static_empty: tuple[int, ...] = ()
    branch: str = "scan"
    windows: tuple[torch.Tensor, torch.Tensor] | None = None
    sizes: tuple[int, int] | None = None      # (s_y, s_x) of the windows
    group: int = 0                             # parts per joint group
    chunk: int = 0                             # samples per 'place' call

    def samples(self, sl: slice) -> FoldPlan:
        """This plan for the samples ``sl`` of its batch (a batch chunk)."""
        y0, x0 = self.windows
        return dataclasses.replace(self, masks_r=self.masks_r[sl],
                                   windows=(y0[sl], x0[sl]))


PLACE_IMPLS = ("auto", "kernel", "xla")


def _place(place_impl: str) -> str:
    """The placement as the fold knows it: 'xla', or 'kernel' for 'auto'
    and 'kernel'; raises on an unknown one."""
    if place_impl not in PLACE_IMPLS:
        raise ValueError(f"invalid place_impl {place_impl!r}; one of "
                         f"{PLACE_IMPLS}")
    return "xla" if place_impl == "xla" else "kernel"


def kernel_places(place_impl: str, warp_agg: str, device=None) -> bool:
    """The kernel-placement rule: ``fold_place`` places a windowed max fold
    unless the placement is 'xla' (where the shape qualifies). Given a
    ``device``, whether the card's kernel places it there (a CUDA device;
    the CPU runs its plain version): ``train.engine.auto_windowed``'s
    question."""
    return _place(place_impl) == "kernel" and warp_agg == "max" \
        and (device is None or torch.device(device).type == "cuda")


@dataclasses.dataclass(frozen=True)
class FoldSettings:
    """The fold settings of a generator, or of one direct ``plan_folds``
    call, checked when made: an unknown backend or placement raises, and
    ``place`` is normalised ('auto' is 'kernel'). ``plan`` makes a
    forward's ``FoldPlan`` list from them."""
    warp_skip: str = "mask"
    warp_agg: str = "max"
    windowed: bool = False
    static_empty: tuple[int, ...] = ()
    backend: str = "matmul"
    place: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"invalid warp backend {self.backend!r}; one "
                             f"of {BACKENDS}")
        object.__setattr__(self, "place", _place(self.place))
        object.__setattr__(self, "static_empty", tuple(self.static_empty))

    def plan(self, shapes, warps: torch.Tensor, masks: torch.Tensor | None,
             dtype: torch.dtype) -> list[FoldPlan]:
        """``plan_folds`` under these settings."""
        with span("fold.plan", instances=len(shapes)):
            plans, pending = [], []
            actives = _place_actives(warps.shape[1], self.static_empty)
            kernel = kernel_places(self.place, self.warp_agg)
            for n, h, w, c in shapes:
                masks_r = None
                if self.warp_skip == "mask":
                    if masks is None:
                        raise ValueError("warp_skip='mask' requires part "
                                         "masks")
                    masks_r = resize_bilinear(masks.to(dtype), (h, w))
                plan = FoldPlan(masks_r, self.warp_agg, self.static_empty)
                plans.append(plan)
                if self.backend == "exact":
                    plan.branch = "exact"
                elif self.backend == "pallas" and self.warp_agg == "max" \
                        and warp_pallas.supported(h, w):
                    plan.branch = "pallas"
                elif self.windowed and masks_r is not None \
                        and _windowable(h, w):
                    sizes = _kernel_window_sizes(h, w)
                    if kernel and actives and sizes is not None \
                            and warp_fused.supported(h, w, c, *sizes):
                        plan.branch, align = "place", warp_fused.X_ALIGN
                        plan.chunk = _place_batch_chunk(
                            n, h, w, c, len(actives), dtype.itemsize)
                    else:
                        plan.branch, align = "xla", 1
                        sizes = (h // 2, w // 2)
                    y0, x0, fits, _ = _support_windows(masks_r, *sizes,
                                                       align)
                    plan.windows, plan.sizes = (y0, x0), sizes
                    plan.group = _joint_group()
                    pending.append((plan, fits[:, 1:].all()))
            if pending:
                flags = torch.stack([f for _, f in pending])
                with span("fold.plan_sync"):
                    flags = flags.tolist()
                for (plan, _), ok in zip(pending, flags):
                    if not ok:
                        plan.branch = "fallback"
            return plans


def plan_folds(shapes, warps: torch.Tensor, masks: torch.Tensor | None,
               dtype: torch.dtype, warp_skip: str = "mask",
               warp_agg: str = "max", windowed: bool = False,
               static_empty: tuple[int, ...] = (),
               backend: str = "matmul",
               place_impl: str = "auto") -> list[FoldPlan]:
    """Plan the fold instances of one forward, one per (N, h, w, C) shape.

    Resizes the masks for every instance and decides its branch: 'exact'
    under ``backend='exact'``; 'pallas' for a supported max fold under
    ``backend='pallas'``; for a windowed, masked instance of a windowable
    shape 'place' where ``kernel_places`` and the kernel takes the shape
    (widened, aligned windows), else 'xla' ((h/2, w/2) windows), either
    one 'fallback' where some part does not fit its window (all fit flags
    resolved with ONE host sync); else 'scan'. A generator checks its
    settings once (``FoldSettings``) and calls ``FoldSettings.plan``.
    """
    return FoldSettings(warp_skip, warp_agg, windowed, static_empty, backend,
                        place_impl).plan(shapes, warps, masks, dtype)


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


def _scan_fwd(features, warps, plan, init_image_size, emit_idx):
    return _fold_scan(features, warps, plan.masks_r, init_image_size,
                      plan.warp_agg, plan.static_empty, emit_idx)


def _fallback_fwd(features, warps, plan, init_image_size, emit_idx):
    COUNTS["scan_fallback"] += 1
    return _scan_fwd(features, warps, plan, init_image_size, emit_idx)


class _Branch(typing.NamedTuple):
    """How a branch runs: ``fwd(features, warps, plan, init_image_size,
    emit_idx) → (out, idx)``; ``bwd(g, warps, idx, plan, init_image_size)
    → f32 feature gradient``, ``WarpFold``'s backward (None where the
    branch has its own); ``grad(features, warps, plan, init_image_size)``,
    the forward where the features need a gradient."""
    fwd: typing.Callable
    bwd: typing.Callable | None
    grad: typing.Callable


class WarpFold(torch.autograd.Function):
    """The fold as an autograd Function: forward on the branch its
    ``FoldPlan`` chose, with the argmax; backward routes the cotangent
    through it (JAX: ``warp_fold_matmul``'s ``_fold_fwd``/``_fold_bwd``).

    Saved: warps, resized masks, the argmax (int8, feature-shaped) and the
    window starts — no feature maps, no banded weights; the plan's other
    decisions ride along without its tensors. Gradient: features only;
    warps and masks are host data and get none.
    """

    @staticmethod
    def forward(ctx, features, warps, plan, init_image_size):
        out, idx = _BRANCHES[plan.branch].fwd(features, warps, plan,
                                              init_image_size, True)
        y0, x0 = plan.windows or (None, None)
        ctx.save_for_backward(warps, plan.masks_r, idx, y0, x0)
        ctx.plan = dataclasses.replace(plan, masks_r=None, windows=None)
        ctx.init_image_size = init_image_size
        return out

    @staticmethod
    def backward(ctx, g):
        warps, masks_r, idx, y0, x0 = ctx.saved_tensors
        plan = dataclasses.replace(
            ctx.plan, masks_r=masks_r,
            windows=None if y0 is None else (y0, x0))
        # g reaches here through NCHW views and channel slices: the router
        # kernel takes a contiguous, 16-byte aligned map
        if not g.is_contiguous() or g.data_ptr() % 16:
            g = g.clone(memory_format=torch.contiguous_format)
        with span(f"fold.bwd.{g.shape[1]}x{g.shape[2]}", branch=plan.branch):
            df = _BRANCHES[plan.branch].bwd(g, warps, idx, plan,
                                            ctx.init_image_size)
            return df.to(g.dtype), None, None, None


_BRANCHES = {
    "place": _Branch(_fold_windowed_place, _fold_windowed_place_bwd,
                     WarpFold.apply),
    "xla": _Branch(_fold_windowed, _fold_windowed_bwd, WarpFold.apply),
    "scan": _Branch(_scan_fwd, _fold_scan_bwd, WarpFold.apply),
    "fallback": _Branch(_fallback_fwd, _fold_scan_bwd, WarpFold.apply),
    "pallas": _Branch(
        lambda f, w, plan, size, emit_idx: warp_pallas.warp_fold(
            *_pallas_args(f, w, plan.masks_r, size), emit_idx),
        None,
        lambda f, w, plan, size: warp_pallas.WarpFoldPallas.apply(
            *_pallas_args(f, w, plan.masks_r, size))),
    # recomputed in the backward: autograd would otherwise keep every part's
    # gathered taps
    "exact": _Branch(
        lambda f, w, plan, size, _: (_fold_exact(f, w, plan, size), None),
        None,
        lambda *a: torch.utils.checkpoint.checkpoint(_fold_exact, *a,
                                                     use_reentrant=False)),
}


def apply_plan(features: torch.Tensor, warps: torch.Tensor, plan: FoldPlan,
               init_image_size: tuple[int, int]) -> torch.Tensor:
    """One fold instance on its ``plan_folds`` entry, which holds the
    resized masks and every setting: warp + (mask) + aggregate over the T
    part transforms, (N, h, w, C) NHWC features and (N, T, 8) warps →
    (N, h, w, C).

    Differentiable in ``features`` (``WarpFold``, or ``WarpFoldPallas`` on
    the fused branch, or the 'exact' fold under ``torch.utils.checkpoint``)
    when grad mode is on and they require grad; otherwise the forward alone
    runs, without the argmax (serving and the discriminator phase's
    generator forward).
    """
    branch = _BRANCHES[plan.branch]
    _, h, w, _ = features.shape
    with span(f"fold.fwd.{h}x{w}", branch=plan.branch):
        if torch.is_grad_enabled() and features.requires_grad:
            return branch.grad(features, warps, plan, init_image_size)
        return branch.fwd(features, warps, plan, init_image_size, False)[0]


def affine_transform_layer(features: torch.Tensor, warps: torch.Tensor,
                           masks: torch.Tensor | None,
                           init_image_size: tuple[int, int],
                           warp_skip: str = "mask",
                           warp_agg: str = "max",
                           windowed: bool = False,
                           static_empty: tuple[int, ...] = (),
                           backend: str = "matmul",
                           place_impl: str = "auto") -> torch.Tensor:
    """Warp + (mask) + aggregate over the T part transforms: the one
    instance planned by ``plan_folds`` and run by ``apply_plan``.

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
      backend: 'matmul', 'pallas' or 'exact'.
      place_impl: the windowed placement, 'auto', 'kernel' or 'xla'.

    Returns:
      (N, h, w, C) aggregated warped features.
    """
    plan = plan_folds([tuple(features.shape)], warps, masks, features.dtype,
                      warp_skip, warp_agg, windowed, static_empty, backend,
                      place_impl)[0]
    return apply_plan(features, warps, plan, init_image_size)
