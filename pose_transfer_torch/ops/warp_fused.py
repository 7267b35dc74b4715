"""The fold's window kernels: ``fold_place`` (forward), ``fold_route``
(backward) and ``fold_place_stream`` (the forward, one part group at a
time); and the two-pass warp's tap kernels, ``warp_taps`` (the windowed
warp) and ``warp_taps_t`` (its transpose).

Counterpart of ``pose_transfer_tpu/ops/warp_fused.py::fold_place``,
``::fold_route`` and ``::fold_place_stream``. The deformable warp fold is
max_t(warp_t(features)·mask_t); the windowed fold computes each non-body
part's warp only inside its mask's bounding-box window, and ``fold_place``
places those windows into the running max (and argmax), multiplies in the
mask windows and applies the final zero-contribution pass. ``fold_route`` is
its backward router: it sends the cotangent of every pixel to the part that
won it (the argmax), times that part's mask, as per-part window cotangents
and a body route. ``fold_place_stream`` places one group of parts into an
existing (running max, argmax) state, in place, with no body init and no
zero pass: a caller that warps the parts group by group never holds every
part's windows at once (``tools/bench_fold.py --experiment partstream``).
``warp_taps`` and ``warp_taps_t`` replace no TPU kernel: they compute the
two banded products of ``ops.warp._warp_win`` and ``_warp_win_t`` (dots on
the TPU's MXU) on the card from the transforms, two taps a pass, where
dense banded weights would be built on every call.

Three pieces for each kernel, as for every kernel of the port:
- the wrapper (``fold_place``, ``fold_route``, ``fold_place_stream``,
  ``warp_taps``, ``warp_taps_t``). A CPU tensor takes the plain version; a
  CUDA tensor launches the hand-written kernel (``csrc/fold_place.cu``,
  ``csrc/fold_route.cu``, ``csrc/fold_place_stream.cu``,
  ``csrc/warp_taps.cu``, built by ``pose_transfer_torch._build``) or
  raises. No path falls back from the kernel to the plain version. No
  output carries a gradient, so the wrappers refuse, under grad mode, an
  input that requires grad: the fold is differentiated by
  ``ops.warp.WarpFold``, which calls them with grad mode off (or with
  inputs that need no gradient).
- the plain PyTorch version (``*_reference``), same semantics.
- ``LAUNCHES``: how many times each CUDA kernel was launched
  (``fold_place_idx`` counts the ``fold_place`` launches that emitted the
  argmax, the ones a backward routes through), registered with
  ``ops.launches``.

Differences from the TPU kernels: the argmax is int8 (the TPU kept it in
bf16 only because Mosaic scalarizes int8 selects), ``zero_nb`` is bool, and
there is no VMEM budget — only the shape rules of ``supported``.
"""

from __future__ import annotations

import torch

from .launches import count_launch, kernel_lib, launch, register

# Window x-start alignment. The TPU kernel needed sublane-aligned dynamic
# starts; the port keeps the rule so that the same stages and batches take
# the windowed branch as in the JAX package.
X_ALIGN = 16
RCH = 8          # window rows must be a multiple of this

LAUNCHES = register({"fold_place": 0, "fold_place_idx": 0, "fold_route": 0,
                     "fold_place_stream": 0, "warp_taps": 0,
                     "warp_taps_t": 0})

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def supported(h: int, w: int, c: int, s_y: int, s_x: int) -> bool:
    """Shapes the placement kernel takes (the JAX package's shape rules)."""
    return s_y % RCH == 0 and s_x % 16 == 0 and w % X_ALIGN == 0 \
        and c % 8 == 0


def fold_place_reference(body: torch.Tensor, wins: torch.Tensor,
                         mwins: torch.Tensor, zero_nb: torch.Tensor,
                         offs: torch.Tensor, emit_idx: bool = True):
    """Plain PyTorch version of ``fold_place`` (same arguments/results)."""
    out = body.clone()
    idx = torch.zeros(body.shape, dtype=torch.int8, device=body.device) \
        if emit_idx else None
    fold_place_stream_reference(out, idx, wins, mwins, offs)
    # zero pass: where some non-body part contributes an exact zero and the
    # running max is negative, zero wins (idx -1)
    take0 = zero_nb[..., None] & (out.float() < 0)
    out = torch.where(take0, torch.zeros((), dtype=out.dtype,
                                         device=out.device), out)
    if emit_idx:
        idx = torch.where(take0, torch.full_like(idx, -1), idx)
    return out, idx


def fold_place_stream_reference(acc: torch.Tensor, idx: torch.Tensor | None,
                                wins: torch.Tensor, mwins: torch.Tensor,
                                offs: torch.Tensor):
    """Plain PyTorch version of ``fold_place_stream``: the part loop of
    ``fold_place``, writing into ``acc`` (and ``idx``) in place."""
    sy, sx = wins.shape[2:4]
    for i, rows in enumerate(offs.tolist()):
        for j, (y0, x0, part) in enumerate(rows):
            win = (slice(y0, y0 + sy), slice(x0, x0 + sx))
            cur = acc[i][win]
            # multiply in f32, round to the compute dtype BEFORE the compare
            z = (wins[i, j].float() * mwins[i, j].float()[..., None]) \
                .to(acc.dtype)
            take = z.float() > cur.float()        # strict: earliest part wins
            if idx is not None:
                idx[i][win] = torch.where(
                    take, torch.full_like(idx[i][win], part), idx[i][win])
            acc[i][win] = torch.where(take, z, cur)
    return acc, idx


def fold_route_reference(g: torch.Tensor, idx: torch.Tensor,
                         mask0: torch.Tensor, mwins: torch.Tensor,
                         offs: torch.Tensor):
    """Plain PyTorch version of ``fold_route`` (same arguments/results)."""
    n = g.shape[0]
    sy, sx = mwins.shape[2:]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    # select in g's dtype (+0 where deselected), multiply in f32, round once
    gbody = (torch.where(idx == 0, g, zero).float()
             * mask0.float()[..., None]).to(g.dtype)
    offs = offs.long()
    rows = offs[..., 0, None] + torch.arange(sy, device=g.device)
    cols = offs[..., 1, None] + torch.arange(sx, device=g.device)
    ni = torch.arange(n, device=g.device)[:, None, None, None]
    at = (ni, rows[..., :, None], cols[..., None, :])   # (N, P, SY, SX)
    sel = idx[at] == offs[..., 2, None, None, None].to(idx.dtype)
    gwins = (torch.where(sel, g[at], zero).float()
             * mwins.float()[..., None]).to(g.dtype)
    return gwins, gbody


def _refuse_grad(name: str, tensors) -> None:
    """Raise on an input that requires grad under grad mode: the kernels'
    outputs carry no gradient, so autograd would silently stop there."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the output carries no "
            "gradient; differentiate the fold through "
            "ops.warp.affine_transform_layer (WarpFold)")


def _check_place(body, wins, mwins, zero_nb, offs):
    n, h, w, c = body.shape
    if body.dtype not in _DTYPE_CODES:
        raise TypeError(f"fold_place: unsupported dtype {body.dtype}")
    if wins.dtype != body.dtype or mwins.dtype != body.dtype:
        raise TypeError("fold_place: body, wins and mwins must share a dtype")
    if zero_nb.dtype != torch.bool or offs.dtype != torch.int32:
        raise TypeError("fold_place: zero_nb must be bool and offs int32")
    if wins.ndim != 5 or wins.shape[0] != n or wins.shape[4] != c:
        raise ValueError(f"fold_place: wins {tuple(wins.shape)} does not "
                         f"match body {tuple(body.shape)}")
    p, sy, sx = wins.shape[1:4]
    if tuple(mwins.shape) != (n, p, sy, sx) \
            or tuple(zero_nb.shape) != (n, h, w) \
            or tuple(offs.shape) != (n, p, 3):
        raise ValueError("fold_place: mwins/zero_nb/offs shapes do not match")
    if sy > h or sx > w:
        raise ValueError("fold_place: window larger than the feature map")
    if not 1 <= p <= 32:
        raise ValueError(f"fold_place: needs 1 <= P <= 32, got P={p}")
    return n, h, w, c, p, sy, sx


def _check_route(g, idx, mask0, mwins, offs):
    if g.ndim != 4:
        raise ValueError(f"fold_route: g must be (N, H, W, C), got "
                         f"{tuple(g.shape)}")
    n, h, w, c = g.shape
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"fold_route: unsupported dtype {g.dtype}")
    if mask0.dtype != g.dtype or mwins.dtype != g.dtype:
        raise TypeError("fold_route: g, mask0 and mwins must share a dtype")
    if idx.dtype != torch.int8 or offs.dtype != torch.int32:
        raise TypeError("fold_route: idx must be int8 and offs int32")
    if mwins.ndim != 4 or mwins.shape[0] != n:
        raise ValueError(f"fold_route: mwins {tuple(mwins.shape)} does not "
                         f"match g {tuple(g.shape)}")
    p, sy, sx = mwins.shape[1:]
    if idx.shape != g.shape or tuple(mask0.shape) != (n, h, w) \
            or tuple(offs.shape) != (n, p, 3):
        raise ValueError("fold_route: idx/mask0/offs shapes do not match")
    if sy > h or sx > w:
        raise ValueError("fold_route: window larger than the feature map")
    if not 1 <= p <= 32:
        raise ValueError(f"fold_route: needs 1 <= P <= 32, got P={p}")
    return n, h, w, c, p, sy, sx


def _check_stream(acc, idx, wins, mwins, offs):
    if acc.ndim != 4:
        raise ValueError(f"fold_place_stream: acc must be (N, H, W, C), got "
                         f"{tuple(acc.shape)}")
    n, h, w, c = acc.shape
    if acc.dtype not in _DTYPE_CODES:
        raise TypeError(f"fold_place_stream: unsupported dtype {acc.dtype}")
    if wins.dtype != acc.dtype or mwins.dtype != acc.dtype:
        raise TypeError("fold_place_stream: acc, wins and mwins must share a "
                        "dtype")
    if (idx is not None and idx.dtype != torch.int8) \
            or offs.dtype != torch.int32:
        raise TypeError("fold_place_stream: idx must be int8 and offs int32")
    if wins.ndim != 5 or wins.shape[0] != n or wins.shape[4] != c:
        raise ValueError(f"fold_place_stream: wins {tuple(wins.shape)} does "
                         f"not match acc {tuple(acc.shape)}")
    p, sy, sx = wins.shape[1:4]
    if (idx is not None and idx.shape != acc.shape) \
            or tuple(mwins.shape) != (n, p, sy, sx) \
            or tuple(offs.shape) != (n, p, 3):
        raise ValueError("fold_place_stream: idx/mwins/offs shapes do not "
                         "match")
    if sy > h or sx > w:
        raise ValueError("fold_place_stream: window larger than the feature "
                         "map")
    if not 1 <= p <= 32:
        raise ValueError(f"fold_place_stream: needs 1 <= P <= 32, got P={p}")
    return n, h, w, c, p, sy, sx


def _on_card(name, tensors, c):
    """Whether to launch the kernel (CUDA) or run the plain version (CPU);
    raises on a layout the kernel does not take (the callers' shape checks
    hold the rest)."""
    first = tensors[0]
    if first.device.type == "cpu":
        if any(t.device.type != "cpu" for t in tensors):
            raise ValueError(f"{name}: tensors on different devices")
        return False
    if first.device.type != "cuda" \
            or any(t.device != first.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    vec = 16 // first.element_size()
    if c % vec:
        raise ValueError(f"{name}: needs C % {vec} == 0, got C={c}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return True


def fold_place(body: torch.Tensor, wins: torch.Tensor, mwins: torch.Tensor,
               zero_nb: torch.Tensor, offs: torch.Tensor,
               emit_idx: bool = True):
    """Window-placement max fold (mask multiply and zero pass fused in).

    Args:
      body: (N, H, W, C) pre-masked full-resolution body warp (part 0),
        float32 or bfloat16.
      wins: (N, P, SY, SX, C) UNMASKED windowed part warps, in fold order.
      mwins: (N, P, SY, SX) resized-mask windows.
      zero_nb: (N, H, W) bool: some non-body part contributes an exact
        zero here (drives the final zero pass).
      offs: (N, P, 3) int32 [y0, x0, part_index]; windows in-bounds,
        part_index is what the argmax stores.
      emit_idx: also return the argmax (off on the no-grad path).

    Returns:
      (out (N, H, W, C), idx (N, H, W, C) int8 or None): out is the max
      fold with the zero pass applied; idx holds the winning part's index,
      0 for the body, -1 where the zero pass won.
    """
    n, h, w, c, p, sy, sx = _check_place(body, wins, mwins, zero_nb, offs)
    tensors = (body, wins, mwins, zero_nb, offs)
    _refuse_grad("fold_place", tensors)
    if not _on_card("fold_place", tensors, c):
        return fold_place_reference(body, wins, mwins, zero_nb, offs,
                                    emit_idx)
    lib = kernel_lib("fold_place", 7, 9)
    out = torch.empty_like(body)
    idx = torch.empty(body.shape, dtype=torch.int8, device=body.device) \
        if emit_idx else None
    launch("fold_place", lib, body.device,
           body.data_ptr(), wins.data_ptr(), mwins.data_ptr(),
           zero_nb.data_ptr(), offs.data_ptr(), out.data_ptr(),
           idx.data_ptr() if emit_idx else None,
           n, h, w, c, p, sy, sx, _DTYPE_CODES[body.dtype], int(emit_idx))
    count_launch(LAUNCHES, "fold_place",
                 *(("fold_place_idx",) if emit_idx else ()))
    return out, idx


def fold_route(g: torch.Tensor, idx: torch.Tensor, mask0: torch.Tensor,
               mwins: torch.Tensor, offs: torch.Tensor):
    """Backward router of ``fold_place``: per-part window cotangents and
    the body route.

    Args:
      g: (N, H, W, C) fold cotangent, float32 or bfloat16.
      idx: (N, H, W, C) int8 argmax from ``fold_place`` (original part
        indices; -1 entries route to no part).
      mask0: (N, H, W) resized body mask (multiplies the body route).
      mwins: (N, P, SY, SX) resized-mask windows of the placed parts.
      offs: (N, P, 3) int32 [y0, x0, part_index], as for ``fold_place``;
        windows in bounds.

    Returns:
      gwins: (N, P, SY, SX, C) g·mwins inside each part's window where idx
        equals the part's index, +0 (times the mask) elsewhere;
      gbody: (N, H, W, C) g·mask0 where idx == 0, else +0. Both in g's
      dtype, multiplied in f32 and rounded once.
    """
    n, h, w, c, p, sy, sx = _check_route(g, idx, mask0, mwins, offs)
    tensors = (g, idx, mask0, mwins, offs)
    _refuse_grad("fold_route", tensors)
    if not _on_card("fold_route", tensors, c):
        return fold_route_reference(g, idx, mask0, mwins, offs)
    lib = kernel_lib("fold_route", 7, 8)
    gwins = torch.empty((n, p, sy, sx, c), dtype=g.dtype, device=g.device)
    gbody = torch.empty_like(g)
    launch("fold_route", lib, g.device,
           g.data_ptr(), idx.data_ptr(), mask0.data_ptr(), mwins.data_ptr(),
           offs.data_ptr(), gwins.data_ptr(), gbody.data_ptr(),
           n, h, w, c, p, sy, sx, _DTYPE_CODES[g.dtype])
    count_launch(LAUNCHES, "fold_route")
    return gwins, gbody


def fold_place_stream(acc: torch.Tensor, idx: torch.Tensor | None,
                      wins: torch.Tensor, mwins: torch.Tensor,
                      offs: torch.Tensor):
    """Fold one part group into the (acc, idx) state, in place.

    The caller initialises the state from the pre-masked body warp (idx 0)
    and applies the zero pass after the last group; over all groups in fold
    order the result equals ``fold_place`` on the whole stack.

    Args:
      acc: (N, H, W, C) running max, float32 or bfloat16; updated in place.
      idx: (N, H, W, C) int8 running argmax, updated in place, or None (the
        primal-only stream).
      wins: (N, Pg, SY, SX, C) UNMASKED windowed warps of the group's
        parts, in fold order.
      mwins: (N, Pg, SY, SX) their resized-mask windows.
      offs: (N, Pg, 3) int32 [y0, x0, part_index]; windows in bounds.

    Returns:
      (acc, idx): the same tensors, updated.
    """
    n, h, w, c, p, sy, sx = _check_stream(acc, idx, wins, mwins, offs)
    tensors = tuple(t for t in (acc, idx, wins, mwins, offs) if t is not None)
    _refuse_grad("fold_place_stream", tensors)
    if not _on_card("fold_place_stream", tensors, c):
        return fold_place_stream_reference(acc, idx, wins, mwins, offs)
    lib = kernel_lib("fold_place_stream", 5, 8)
    launch("fold_place_stream", lib, acc.device,
           acc.data_ptr(), idx.data_ptr() if idx is not None else None,
           wins.data_ptr(), mwins.data_ptr(), offs.data_ptr(),
           n, h, w, c, p, sy, sx, _DTYPE_CODES[acc.dtype])
    count_launch(LAUNCHES, "fold_place_stream")
    return acc, idx


def _tap_positions(coeffs: torch.Tensor, s_y: int, s_x: int):
    """The windows' output rows, (N, P, S_y, 1) f32 ``(y0 + o) + 0.5``, and
    the horizontal pass's source positions u, (N, P, S_y, S_x), of (N, P,
    8) coefficients (m00, m01, tx, m10, m11, ty, y0, x0)."""
    dev = coeffs.device
    m00, m01, tx, _, _, _, y0, x0 = (coeffs[..., k, None, None]
                                     for k in range(8))
    yo = (y0 + torch.arange(s_y, dtype=torch.float32, device=dev)[:, None]) \
        + 0.5
    xo = (x0 + torch.arange(s_x, dtype=torch.float32, device=dev)) + 0.5
    return yo, m00 * xo + m01 * yo + tx - 0.5


def _taps(q: torch.Tensor, n: int, dtype: torch.dtype):
    """The two bilinear taps of f32 positions ``q`` along an axis of ``n``:
    [(index clamped in range, f32 weight max(0, 1 - |q - j|) rounded to
    ``dtype``, in range)] for j = floor(q) and floor(q) + 1."""
    j0 = torch.floor(q)
    taps = []
    for j in (j0, j0 + 1):
        weight = (1.0 - (q - j).abs()).clamp(min=0.0).to(dtype).float()
        valid = (j >= 0) & (j < n)
        taps.append((j.clamp(0, n - 1).long(), weight, valid))
    return taps


def warp_taps_reference(features: torch.Tensor, coeffs: torch.Tensor,
                        s_y: int, s_x: int) -> torch.Tensor:
    """Plain PyTorch version of ``warp_taps`` (same arguments/result): the
    kernel's algorithm, every output gathering its 2×2 taps; products and
    sums in f32, rounded to the features' dtype after each pass."""
    n, h, w, c = features.shape
    p = coeffs.shape[1]
    dtype = features.dtype
    m10, m11, ty = (coeffs[..., k, None, None] for k in (3, 4, 5))
    yo, u = _tap_positions(coeffs, s_y, s_x)
    flat = features.reshape(n * h * w, c)
    base = (torch.arange(n, device=features.device) * (h * w)) \
        .view(n, 1, 1, 1)
    zero = torch.zeros((), device=features.device)
    q = []
    for xi, wx, valid_x in _taps(u, w, dtype):
        # pass 1 at the tap's source column (the two-pass approximation;
        # an out-of-range tap's value is masked)
        v = m10 * (xi.float() + 0.5) + m11 * yo + ty - 0.5
        pr = []
        for yi, wy, valid_y in _taps(v, h, dtype):
            vals = flat.index_select(0, (base + yi * w + xi).reshape(-1)) \
                .reshape(n, p, s_y, s_x, c).float()
            pr.append(torch.where(valid_y[..., None], wy[..., None] * vals,
                                  zero))
        tmp = (pr[0] + pr[1]).to(dtype).float()
        q.append(torch.where(valid_x[..., None], wx[..., None] * tmp, zero))
    return (q[0] + q[1]).to(dtype)


def warp_taps_t_reference(g_wins: torch.Tensor, coeffs: torch.Tensor,
                          h: int, w: int, joint: bool) -> torch.Tensor:
    """Plain PyTorch version of ``warp_taps_t`` (same arguments/result):
    the transpose of ``warp_taps_reference``, written as the scatter of its
    taps (``index_add_``), where the kernel gathers them. Pass 1 (the
    horizontal taps) sums in f32 and rounds to the cotangents' dtype; pass 2
    (the vertical taps at each source column) sums over parts and window
    rows in f32, and rounds to that dtype unless ``joint``."""
    n, p, s_y, s_x, c = g_wins.shape
    dtype = g_wins.dtype
    dev = g_wins.device
    m10, m11, ty = (coeffs[..., k, None, None] for k in (3, 4, 5))
    yo, u = _tap_positions(coeffs, s_y, s_x)
    zero = torch.zeros((), device=dev)
    g = g_wins.float()
    # pass 1: dtmp[n, p, o, x] = sum over a of wx(o, a, x) * g[n, p, o, a]
    rows = (torch.arange(n * p * s_y, device=dev) * w).view(n, p, s_y, 1)
    dtmp = torch.zeros((n * p * s_y * w, c), dtype=torch.float32, device=dev)
    for xi, wx, valid in _taps(u, w, dtype):
        dtmp.index_add_(0, (rows + xi).reshape(-1), torch.where(
            valid[..., None], wx[..., None] * g, zero).reshape(-1, c))
    dtmp = dtmp.to(dtype).float().view(n, p, s_y, w, c)
    # pass 2: df[n, y, x] = sum over (p, o) of wy(x, p, o, y) * dtmp
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    v = m10 * (xs + 0.5) + m11 * yo + ty - 0.5            # (N, P, S_y, W)
    pix = (torch.arange(n, device=dev) * (h * w)).view(n, 1, 1, 1) \
        + xs.long()
    df = torch.zeros((n * h * w, c), dtype=torch.float32, device=dev)
    for yi, wy, valid in _taps(v, h, dtype):
        df.index_add_(0, (pix + yi * w).reshape(-1), torch.where(
            valid[..., None], wy[..., None] * dtmp, zero).reshape(-1, c))
    df = df.view(n, h, w, c)
    return df if joint else df.to(dtype)


def _check_taps(name, x, coeffs, ndim):
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d input, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if coeffs.dtype != torch.float32 or coeffs.ndim != 3 \
            or tuple(coeffs.shape) != (x.shape[0], coeffs.shape[1], 8) \
            or (ndim == 5 and coeffs.shape[1] != x.shape[1]):
        raise ValueError(f"{name}: coeffs must be (N, P, 8) float32, got "
                         f"{tuple(coeffs.shape)} {coeffs.dtype}")


def warp_taps(features: torch.Tensor, coeffs: torch.Tensor, s_y: int,
              s_x: int) -> torch.Tensor:
    """The windowed two-pass warp of every part, from its taps.

    Args:
      features: (N, H, W, C), float32 or bfloat16.
      coeffs: (N, P, 8) f32 rows (m00, m01, tx, m10, m11, ty, y0, x0): the
        inverse affine with its translation scaled to the feature
        resolution, and the window's start.
      s_y, s_x: the window's size.

    Returns:
      (N, P, S_y, S_x, C) in the features' dtype: ``ops.warp._warp_win``'s
      windows (the same taps, weights and roundings; the banded products'
      f32 sums may differ in the last bit).
    """
    _check_taps("warp_taps", features, coeffs, 4)
    n, h, w, c = features.shape
    p = coeffs.shape[1]
    _refuse_grad("warp_taps", (features, coeffs))
    if not _on_card("warp_taps", (features, coeffs), c):
        return warp_taps_reference(features, coeffs, s_y, s_x)
    out = torch.empty((n, p, s_y, s_x, c), dtype=features.dtype,
                      device=features.device)
    lib = kernel_lib("warp_taps", 3, 8)
    launch("warp_taps", lib, features.device,
           features.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
           n, h, w, c, p, s_y, s_x, _DTYPE_CODES[features.dtype])
    count_launch(LAUNCHES, "warp_taps")
    return out


def warp_taps_t(g_wins: torch.Tensor, coeffs: torch.Tensor, h: int, w: int,
                joint: bool) -> torch.Tensor:
    """Transpose of ``warp_taps``: window cotangents → feature gradient,
    summed over the parts.

    Args:
      g_wins: (N, P, S_y, S_x, C) window cotangents, float32 or bfloat16.
      coeffs: (N, P, 8) f32, as for ``warp_taps``.
      h, w: the feature map's size.
      joint: f32 gradient summed over (part, window row) in f32 (the
        windows' backward); else rounded to the cotangents' dtype.

    Returns:
      (N, H, W, C), f32 if ``joint`` else in g's dtype.
    """
    _check_taps("warp_taps_t", g_wins, coeffs, 5)
    n, p, s_y, s_x, c = g_wins.shape
    _refuse_grad("warp_taps_t", (g_wins, coeffs))
    if not _on_card("warp_taps_t", (g_wins, coeffs), c):
        return warp_taps_t_reference(g_wins, coeffs, h, w, joint)
    out = torch.empty((n, h, w, c),
                      dtype=torch.float32 if joint else g_wins.dtype,
                      device=g_wins.device)
    lib = kernel_lib("warp_taps", 3, 9, "warp_taps_t")
    launch("warp_taps_t", lib, g_wins.device,
           g_wins.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
           n, h, w, c, p, s_y, s_x, _DTYPE_CODES[g_wins.dtype], int(joint),
           source="warp_taps")
    count_launch(LAUNCHES, "warp_taps_t")
    return out
