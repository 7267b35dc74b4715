"""The plain reference of the deformable pose-transfer GAN (Siarohin et
al., arXiv 1801.00055): generator and discriminator as functions of a dict
of parameters, in float32, in plain PyTorch.

Parameters are named as the published PyTorch state_dict names them
(``encoder_app.net.0.weight``, ``decoder.net.3.net.1.weight``, ...), so one
dict of weights loads into the program and feeds this file. Everything the
program derives from a compact batch is worked out here again: Gaussian
heatmaps, the part masks rasterized from their polygons, the masks resized
to each skip's resolution, the two-pass affine warps and the max fold.

Everything is computed in float32 but the part affines, which the
configuration states in its compute dtype (``affine_dtype``): they are
the warp's parameters, and a bfloat16 affine moves a sample position by
up to half a pixel at 256², as the program's does.

Departures from the published description, each the program's stated
semantics:
- the warp is the two-pass (Catmull-Smith) resample: a vertical linear
  interpolation at each source column, then a horizontal one, where
  ``tf.contrib.image.transform`` samples bilinearly in one pass. For a
  transform with a vertical shear term the two differ by up to that
  term in pixels. Out-of-range taps read zero.
- the masks are resized by two-tap bilinear interpolation with half-pixel
  centres and clamped borders (cv2's INTER_LINEAR), not nearest neighbour;
- the block norm is the reference code's ``InstanceNorm3d(1)`` on the
  (N, 1, C, H, W) view: one mean and variance per sample over the whole
  volume, one scalar weight and bias per layer (eps 1e-3);
- the max fold routes the gradient of a tie to the earliest part.

``q`` is applied to both operands of every convolution; the identity gives
the reference, a rounding to a lower precision gives the control that the
output check has to fail.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NUM_WARP_STAGES = 4
DROPOUT_P = 0.5
NORM_EPS = 1e-3


def ident(x: torch.Tensor) -> torch.Tensor:
    return x


# --------------------------------------------------------------- structure

def ladders(image_size) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(encoder, decoder) filters of the reference's pose_gan.py."""
    if max(image_size) < 256:
        return (64, 128, 256, 512, 512, 512), (512, 512, 512, 256, 128, 3)
    return ((64, 128, 256, 512, 512, 512, 512),
            (512, 512, 512, 512, 256, 128, 3))


def generator_spec(image_size, pose_dim: int) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every generator parameter, in module order;
    kind is 'conv' (Glorot-uniform), 'bias' (0), 'norm_w' (1) or 'norm_b'
    (0)."""
    enc, dec = ladders(image_size)
    spec = []

    def norm(prefix):
        spec.append((f"{prefix}.weight", (1,), "norm_w"))
        spec.append((f"{prefix}.bias", (1,), "norm_b"))

    for name, in_ch in (("encoder_app", 3 + pose_dim),
                        ("encoder_pose", pose_dim)):
        spec.append((f"{name}.net.0.weight", (enc[0], in_ch, 3, 3), "conv"))
        spec.append((f"{name}.net.0.bias", (enc[0],), "bias"))
        for i in range(1, len(enc)):
            spec.append((f"{name}.net.{i}.net.1.weight",
                         (enc[i], enc[i - 1], 4, 4), "conv"))
            if i != len(enc) - 1:
                norm(f"{name}.net.{i}.net.2")
    in_ch = 2 * enc[-1]
    for i in range(len(dec) - 1):
        # transposed convolution weights are (in, out, k, k)
        spec.append((f"decoder.net.{i}.net.1.weight", (in_ch, dec[i], 4, 4),
                     "conv"))
        norm(f"decoder.net.{i}.net.3")
        in_ch = dec[i] + 2 * enc[-(i + 2)]
    last = len(dec)
    spec.append((f"decoder.net.{last}.weight", (dec[-1], in_ch, 3, 3),
                 "conv"))
    spec.append((f"decoder.net.{last}.bias", (dec[-1],), "bias"))
    return spec


def discriminator_spec(pose_dim: int) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every discriminator parameter; its input is
    [image ‖ source pose ‖ candidate ‖ target pose]."""
    in_ch = 6 + 2 * pose_dim
    spec = [("net.0.weight", (64, in_ch, 4, 4), "conv"),
            ("net.0.bias", (64,), "bias")]
    prev = 64
    for i, width in enumerate((128, 256, 512), start=1):
        spec.append((f"net.{i}.net.1.weight", (width, prev, 4, 4), "conv"))
        spec.append((f"net.{i}.net.2.weight", (1,), "norm_w"))
        spec.append((f"net.{i}.net.2.bias", (1,), "norm_b"))
        prev = width
    spec.append(("net.4.net.1.weight", (1, prev, 4, 4), "conv"))
    return spec


# ------------------------------------------------------------ batch prep

def heatmaps(kp: torch.Tensor, image_size, sigma: float = 6.0):
    """(N, K, 2) (y, x) keypoints → (N, H, W, K) Gaussian heatmaps; a
    joint at -1 is missing and its map is zero."""
    h, w = image_size
    kp = kp.float()
    yy = torch.arange(h, dtype=torch.float32, device=kp.device)
    xx = torch.arange(w, dtype=torch.float32, device=kp.device)
    dy = yy[None, :, None, None] - kp[:, None, None, :, 0]
    dx = xx[None, None, :, None] - kp[:, None, None, :, 1]
    maps = torch.exp(-(dy * dy + dx * dx) / (2.0 * sigma * sigma))
    missing = ((kp[..., 0] == -1) | (kp[..., 1] == -1))[:, None, None, :]
    return maps.masked_fill(missing, 0.0)


def part_masks(polys: torch.Tensor, kinds: torch.Tensor, image_size):
    """(N, T, 4, 2) (y, x) polygons and (N, T) kinds → (N, T, H, W) masks:
    kind 0 all ones, 1 the half-open box polys[0] .. polys[1], 2 the
    even-odd quadrilateral (a pixel is inside when an odd number of edges
    cross its row to its right), 3 empty."""
    h, w = image_size
    v = polys.float()[..., None, None]            # (N, T, 4, 2, 1, 1)
    rr = torch.arange(h, dtype=torch.float32, device=polys.device)[:, None]
    cc = torch.arange(w, dtype=torch.float32, device=polys.device)[None, :]
    box = ((rr >= v[:, :, 0, 0]) & (rr < v[:, :, 1, 0])
           & (cc >= v[:, :, 0, 1]) & (cc < v[:, :, 1, 1]))
    quad = torch.zeros_like(box)
    for e in range(4):
        y1, x1 = v[:, :, e, 0], v[:, :, e, 1]
        y2, x2 = v[:, :, (e + 1) % 4, 0], v[:, :, (e + 1) % 4, 1]
        flat = y1 == y2
        x_int = x1 + (rr - y1) * (x2 - x1) / torch.where(flat, 1.0, y2 - y1)
        quad ^= (~flat & (rr >= torch.minimum(y1, y2))
                 & (rr < torch.maximum(y1, y2)) & (cc < x_int))
    k = kinds[..., None, None]
    return ((k == 0) | ((k == 1) & box) | ((k == 2) & quad)).float()


def resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(..., H, W) → (..., h, w) two-tap bilinear, half-pixel centres,
    clamped borders."""
    for axis, n_out in ((-2, out_hw[0]), (-1, out_hw[1])):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        u = (torch.arange(n_out, dtype=torch.float64) + 0.5) \
            * (n_in / n_out) - 0.5
        u0 = torch.floor(u)
        frac = (u - u0).float().to(x.device)
        lo = u0.long().clamp(0, n_in - 1).to(x.device)
        hi = (u0.long() + 1).clamp(0, n_in - 1).to(x.device)
        shape = [1] * x.ndim
        shape[axis] = n_out
        frac = frac.view(shape)
        x = x.index_select(axis, lo) * (1 - frac) \
            + x.index_select(axis, hi) * frac
    return x


def prepare(batch: dict, image_size, device) -> dict:
    """A compact batch (uint8 images, keypoints, fits, polygons, as numpy
    arrays or tensors) → packed input (N, H, W, 3 + 2K), target image,
    warps (N, T, 8) and part masks (N, T, H, W), float32 on ``device``."""
    def t(x):
        return torch.as_tensor(x).to(device)

    img = t(batch["image_from"]).float() / 127.5 - 1.0
    packed = torch.cat([img, heatmaps(t(batch["kp_from"]), image_size),
                        heatmaps(t(batch["kp_to"]), image_size)], dim=-1)
    if "image_to" in batch:
        target = t(batch["image_to"]).float() / 127.5 - 1.0
    else:
        target = torch.full_like(img, -1.0)
    return {"input": packed, "target": target,
            "warps": t(batch["warps"]).float(),
            "masks": part_masks(t(batch["mask_polys"]),
                                t(batch["mask_kinds"]), image_size)}


# ------------------------------------------------------------------- warp

def _lerp_taps(flat: torch.Tensor, pos: torch.Tensor, extent: int,
               index_of) -> torch.Tensor:
    """Σ_j max(0, 1 - |pos - j|)·value(j) over j in [0, extent): the two
    taps at floor(pos) and floor(pos) + 1, zero outside the map."""
    p0 = torch.floor(pos)
    frac = pos - p0
    p0 = p0.long()
    out = None
    for tap, weight in ((p0, 1.0 - frac), (p0 + 1, frac)):
        valid = (tap >= 0) & (tap < extent)
        idx = index_of(tap.clamp(0, extent - 1))
        vals = flat.index_select(0, idx.reshape(-1)).reshape(
            *pos.shape, flat.shape[-1])
        term = vals * (weight * valid)[..., None]
        out = term if out is None else out + term
    return out


def warp(features: torch.Tensor, transform: torch.Tensor,
         image_size) -> torch.Tensor:
    """Two-pass warp of (N, h, w, C) features by (N, 8) inverse affines
    (output pixel → input pixel, estimated at ``image_size``; the
    translation rescaled to this resolution in the affines' dtype, the
    positions computed in float32)."""
    n, h, w, c = features.shape
    dev = features.device
    m00, m01, tx, m10, m11, ty = (transform[:, k, None, None]
                                  for k in range(6))
    tx = (tx * (w / image_size[1])).float()
    ty = (ty * (h / image_size[0])).float()
    m00, m01, m10, m11 = (m.float() for m in (m00, m01, m10, m11))
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + 0.5
    base = (torch.arange(n, device=dev) * (h * w))[:, None, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    rows = torch.arange(h, device=dev)[None, :, None]
    # pass 1: at output row y and source column x, read the source rows
    v = m10 * xs + m11 * ys + ty - 0.5
    tmp = _lerp_taps(features.reshape(n * h * w, c), v, h,
                     lambda yi: base + yi * w + cols)
    # pass 2: at output (y, x), read the pass-1 columns
    u = m00 * xs + m01 * ys + tx - 0.5
    return _lerp_taps(tmp.reshape(n * h * w, c), u, w,
                      lambda xi: base + rows * w + xi)


def fold(features, warps, masks_r, image_size) -> torch.Tensor:
    """max over the T parts of warp_t(features)·mask_t, (N, h, w, C); the
    first part holding the max takes it."""
    acc = None
    for t in range(warps.shape[1]):
        cand = warp(features, warps[:, t], image_size) \
            * masks_r[:, t, ..., None]
        if acc is None:
            acc = cand
        else:
            acc = torch.where(cand > acc, cand, acc)
    return acc


# ---------------------------------------------------------------- networks

def _conv(x, w, b, stride, padding, q):
    return F.conv2d(q(x), q(w), b, stride, padding)


def _norm(x, weight, bias):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + NORM_EPS) * weight + bias


def _encoder(p, prefix, x, depth, q):
    x = _conv(x, p[f"{prefix}.net.0.weight"], p[f"{prefix}.net.0.bias"],
              1, 1, q)
    outs = [x]
    for i in range(1, depth):
        x = _conv(F.leaky_relu(x, 0.2), p[f"{prefix}.net.{i}.net.1.weight"],
                  None, 2, 1, q)
        if i != depth - 1:
            x = _norm(x, p[f"{prefix}.net.{i}.net.2.weight"],
                      p[f"{prefix}.net.{i}.net.2.bias"])
        outs.append(x)
    return outs


def _dropout(x, generator):
    """Whole (sample, channel) planes dropped with probability 0.5 from
    one uniform draw of shape (N, C, 1, 1) per layer; kept planes × 2."""
    if generator is None:
        return x
    keep = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=generator,
                      device=x.device) >= DROPOUT_P
    return torch.where(keep, x / (1.0 - DROPOUT_P), torch.zeros_like(x))


def _decoder(p, skips, n_dec, q, generator):
    out = None
    for i in range(n_dec - 1):
        x = skips[-1] if i == 0 else torch.cat([out, skips[-(i + 1)]], 1)
        x = F.conv_transpose2d(q(F.relu(x)),
                               q(p[f"decoder.net.{i}.net.1.weight"]),
                               None, 2, 1)
        x = _norm(x, p[f"decoder.net.{i}.net.3.weight"],
                  p[f"decoder.net.{i}.net.3.bias"])
        out = _dropout(x, generator) if i < 3 else x
    x = F.relu(torch.cat([out, skips[0]], 1))
    return torch.tanh(_conv(x, p[f"decoder.net.{n_dec}.weight"],
                            p[f"decoder.net.{n_dec}.bias"], 1, 1, q))


def generator(p: dict, batch: dict, image_size, pose_dim: int,
              q=ident, dropout: torch.Generator | None = None,
              affine_dtype: torch.dtype = torch.float32):
    """The generator on a prepared batch → (N, H, W, 3) in [-1, 1].
    ``dropout``: the generator of the decoder's channel dropout (training),
    None for inference. ``affine_dtype``: the precision the configuration
    states for the part affines (its compute dtype)."""
    enc, dec = ladders(image_size)
    inp = batch["input"]
    k = pose_dim
    app = inp[..., :3 + k].permute(0, 3, 1, 2)
    pose = inp[..., 3 + k:].permute(0, 3, 1, 2)
    skips_app = _encoder(p, "encoder_app", app, len(enc), q)
    skips_pose = _encoder(p, "encoder_pose", pose, len(enc), q)
    skips = []
    for i, (a, b) in enumerate(zip(skips_app, skips_pose)):
        if i < NUM_WARP_STAGES:
            h, w = a.shape[2:]
            f = fold(a.permute(0, 2, 3, 1), batch["warps"].to(affine_dtype),
                     resize(batch["masks"], (h, w)), image_size)
            a = f.permute(0, 3, 1, 2)
        skips.append(torch.cat([a, b], 1))
    return _decoder(p, skips, len(dec), q, dropout).permute(0, 2, 3, 1)


def discriminator(p: dict, x: torch.Tensor, q=ident) -> torch.Tensor:
    """(N, H, W, 6 + 2K) → (N, patches) probabilities."""
    x = _conv(x.permute(0, 3, 1, 2), p["net.0.weight"], p["net.0.bias"],
              2, 0, q)
    for i in range(1, 5):
        x = _conv(F.leaky_relu(x, 0.2), p[f"net.{i}.net.1.weight"], None,
                  2, 1, q)
        if i < 4:
            x = _norm(x, p[f"net.{i}.net.2.weight"], p[f"net.{i}.net.2.bias"])
    return torch.sigmoid(x).reshape(x.shape[0], -1)


def disc_input(inp: torch.Tensor, candidate: torch.Tensor,
               pose_dim: int) -> torch.Tensor:
    """[image ‖ source pose ‖ candidate ‖ target pose]."""
    split = 3 + pose_dim
    return torch.cat([inp[..., :split], candidate, inp[..., split:]], -1)
