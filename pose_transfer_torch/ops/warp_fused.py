"""The fold's window-placement kernel: ``fold_place``.

Counterpart of ``pose_transfer_tpu/ops/warp_fused.py::fold_place``. The
deformable warp fold is max_t(warp_t(features)·mask_t); the windowed fold
computes each non-body part's warp only inside its mask's bounding-box
window, and ``fold_place`` places those windows into the running max (and
argmax), multiplies in the mask windows and applies the final
zero-contribution pass.

Three pieces, as for every kernel of the port:
- ``fold_place``: the wrapper. A CPU tensor takes the plain version; a CUDA
  tensor launches the hand-written kernel ``csrc/fold_place.cu`` (built by
  ``pose_transfer_torch._build``) or raises. No path falls back from the
  kernel to the plain version.
- ``fold_place_reference``: the plain PyTorch version, same semantics.
- ``LAUNCHES``: how many times the CUDA kernel was launched.

Differences from the TPU kernel: the argmax is int8 (the TPU kept it in
bf16 only because Mosaic scalarizes int8 selects), ``zero_nb`` is bool, and
there is no VMEM budget — only the shape rules of ``supported``.
"""

from __future__ import annotations

import ctypes

import torch

# Window x-start alignment. The TPU kernel needed sublane-aligned dynamic
# starts; the port keeps the rule so that the same stages and batches take
# the windowed branch as in the JAX package.
X_ALIGN = 16
RCH = 8          # window rows must be a multiple of this

LAUNCHES = {"fold_place": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def supported(h: int, w: int, c: int, s_y: int, s_x: int) -> bool:
    """Shapes the placement kernel takes (the JAX package's shape rules)."""
    return s_y % RCH == 0 and s_x % 16 == 0 and w % X_ALIGN == 0 \
        and c % 8 == 0


def fold_place_reference(body: torch.Tensor, wins: torch.Tensor,
                         mwins: torch.Tensor, zero_nb: torch.Tensor,
                         offs: torch.Tensor, emit_idx: bool = True):
    """Plain PyTorch version of ``fold_place`` (same arguments/results)."""
    n, _, _, _ = body.shape
    p, sy, sx = wins.shape[1:4]
    out = body.clone()
    idx = torch.zeros(body.shape, dtype=torch.int8, device=body.device) \
        if emit_idx else None
    for i, rows in enumerate(offs.tolist()):
        for j, (y0, x0, part) in enumerate(rows):
            win = (slice(y0, y0 + sy), slice(x0, x0 + sx))
            cur = out[i][win]
            # multiply in f32, round to the compute dtype BEFORE the compare
            z = (wins[i, j].float() * mwins[i, j].float()[..., None]) \
                .to(out.dtype)
            take = z.float() > cur.float()        # strict: earliest part wins
            out[i][win] = torch.where(take, z, cur)
            if emit_idx:
                idx[i][win] = torch.where(
                    take, torch.full_like(idx[i][win], part), idx[i][win])
    # zero pass: where some non-body part contributes an exact zero and the
    # running max is negative, zero wins (idx -1)
    take0 = zero_nb[..., None] & (out.float() < 0)
    out = torch.where(take0, torch.zeros((), dtype=out.dtype,
                                         device=out.device), out)
    if emit_idx:
        idx = torch.where(take0, torch.full_like(idx, -1), idx)
    return out, idx


def _check(body, wins, mwins, zero_nb, offs):
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
    return n, h, w, c, p, sy, sx


def _kernel_lib() -> ctypes.CDLL:
    """The built ``csrc/fold_place.cu`` with its C signatures declared."""
    from .. import _build
    lib = _build.load("fold_place")
    if lib.fold_place.argtypes is None:
        lib.fold_place.restype = ctypes.c_int
        lib.fold_place.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.fold_place_error_string.restype = ctypes.c_char_p
        lib.fold_place_error_string.argtypes = [ctypes.c_int]
    return lib


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
    n, h, w, c, p, sy, sx = _check(body, wins, mwins, zero_nb, offs)
    tensors = (body, wins, mwins, zero_nb, offs)
    if body.device.type == "cpu":
        if any(t.device.type != "cpu" for t in tensors):
            raise ValueError("fold_place: tensors on different devices")
        return fold_place_reference(body, wins, mwins, zero_nb, offs,
                                    emit_idx)
    if body.device.type != "cuda" \
            or any(t.device != body.device for t in tensors):
        raise ValueError("fold_place: all tensors must be on one CUDA device")
    vec = 16 // body.element_size()
    if c % vec or p > 32:
        raise ValueError(f"fold_place: needs C % {vec} == 0 and P <= 32, "
                         f"got C={c}, P={p}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fold_place: tensors must be contiguous")
    if body.data_ptr() % 16 or wins.data_ptr() % 16:
        raise ValueError("fold_place: body/wins must be 16-byte aligned")

    lib = _kernel_lib()
    out = torch.empty_like(body)
    idx = torch.empty(body.shape, dtype=torch.int8, device=body.device) \
        if emit_idx else None
    with torch.cuda.device(body.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fold_place(
            body.data_ptr(), wins.data_ptr(), mwins.data_ptr(),
            zero_nb.data_ptr(), offs.data_ptr(), out.data_ptr(),
            idx.data_ptr() if emit_idx else None,
            n, h, w, c, p, sy, sx, _DTYPE_CODES[body.dtype], int(emit_idx),
            stream)
    if rc != 0:
        raise RuntimeError("fold_place kernel launch failed: "
                           + lib.fold_place_error_string(rc).decode())
    LAUNCHES["fold_place"] += 1
    return out, idx
