"""Rasterization of the 10 body-part masks from their compact description.

Counterpart of ``pose_transfer_tpu/ops/masks.py``. The host ships (T, 4, 2)
polygon vertices and (T,) kind codes (``core.transforms_host
.pose_mask_polys``); the masks are rasterized on the device with
compare/parity arithmetic, batched over every leading dimension.

Kind codes: 0 = all-ones (body), 1 = box (head; verts[0]=(y0,x0),
verts[1]=(y1,x1), half-open), 2 = even-odd quad (limbs, strict ``<``),
3 = empty.
"""

from __future__ import annotations

import torch


def _quad_mask(verts: torch.Tensor, rr: torch.Tensor,
               cc: torch.Tensor) -> torch.Tensor:
    """Even-odd crossing-number rasterization of (..., 4, 2) (y, x) quads
    → (..., H, W) bool."""
    crossings = None
    for i in range(4):
        y1 = verts[..., i, 0, None, None]
        x1 = verts[..., i, 1, None, None]
        y2 = verts[..., (i + 1) % 4, 0, None, None]
        x2 = verts[..., (i + 1) % 4, 1, None, None]
        horiz = y1 == y2
        cond = (rr >= torch.minimum(y1, y2)) & (rr < torch.maximum(y1, y2))
        denom = torch.where(horiz, torch.ones_like(y1), y2 - y1)
        x_int = x1 + (rr - y1) * (x2 - x1) / denom
        hit = cond & (cc < x_int) & ~horiz
        crossings = hit if crossings is None else crossings ^ hit
    return crossings


def _box_mask(verts: torch.Tensor, rr: torch.Tensor,
              cc: torch.Tensor) -> torch.Tensor:
    y0 = verts[..., 0, 0, None, None]
    x0 = verts[..., 0, 1, None, None]
    y1 = verts[..., 1, 0, None, None]
    x1 = verts[..., 1, 1, None, None]
    return (rr >= y0) & (rr < y1) & (cc >= x0) & (cc < x1)


def rasterize_part_masks(polys: torch.Tensor, kinds: torch.Tensor,
                         img_size: tuple[int, int]) -> torch.Tensor:
    """(..., T, 4, 2) polys + (..., T) kinds → (..., T, H, W) float32 masks,
    on ``polys``' device."""
    h, w = img_size
    polys = polys.to(torch.float32)
    rr = torch.arange(h, dtype=torch.float32, device=polys.device)[:, None]
    cc = torch.arange(w, dtype=torch.float32, device=polys.device)[None, :]
    k = kinds[..., None, None]
    mask = ((k == 0)
            | ((k == 1) & _box_mask(polys, rr, cc))
            | ((k == 2) & _quad_mask(polys, rr, cc)))
    return mask.to(torch.float32)
