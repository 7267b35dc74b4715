"""Image files without an imaging library: a PNG codec on ``zlib``.

The JAX package reads and writes images through PIL; the port writes and
reads PNG itself, so that it needs no imaging package:

- ``write_png`` (``encode_png``): 8-bit RGB (or grey), every scanline
  with filter 0;
- ``decode_png``: 8-bit grey, grey+alpha, RGB and RGBA, not interlaced,
  with all five scanline filters (PIL writes adaptive filters); returned
  as RGB, alpha dropped, as PIL's ``convert("RGB")`` does. Other colour
  types and bit depths raise ``ValueError`` naming the file;
- ``read_image``: PNG by its signature; JPEG only where PIL imports,
  else an error naming the file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
# colour type → channels, for the 8-bit types the reader takes
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W) uint8 → PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"PNG writer takes (H, W, 3) or (H, W) uint8, got "
                         f"{image.shape} {image.dtype}")
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(image).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if image.ndim == 3 else 0,
                       0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, h: int, w: int, bpp: int, path: str) -> np.ndarray:
    stride = w * bpp
    raw = np.frombuffer(data, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is {raw.size} bytes, "
                         f"expected {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    if not raw[:, 0].any():      # filter 0 throughout, as write_png writes
        return raw[:, 1:].copy()
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:      # sub: running sum along the row, per channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:      # up
            cur = line + prev
        elif kind in (3, 4):  # average, Paeth: left-to-right recurrences
            cur = np.zeros(stride, np.int32)
            up = prev.astype(np.int32)
            x = line.astype(np.int32)
            zero = np.zeros(bpp, np.int32)
            for i in range(0, stride, bpp):
                left = cur[i - bpp:i] if i else zero
                if kind == 3:
                    pred = (left + up[i:i + bpp]) >> 1
                else:
                    pred = _paeth(left, up[i:i + bpp],
                                  up[i - bpp:i] if i else zero)
                cur[i:i + bpp] = (x[i:i + bpp] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"{path}: PNG filter type {kind} is not one of "
                             "0-4")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes → (H, W, 3) uint8 RGB."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, colour type {color}, "
            f"interlace {interlace}; the reader takes 8-bit grey, grey+alpha, "
            "RGB and RGBA, not interlaced")
    ch = _CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch,
                   path).reshape(h, w, ch)
    if ch <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB from a PNG, or from a JPEG where PIL imports."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, path)
    if data.startswith(JPEG_SIGNATURE):
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(
                f"{path}: a JPEG file, and PIL is not installed to decode "
                "it; the port's own datasets are PNG") from None
        import io
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")
