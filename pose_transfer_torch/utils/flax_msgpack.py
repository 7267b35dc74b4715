"""Read and write the msgpack files of ``flax.serialization``.

The JAX package saves its checkpoints with ``flax.serialization.to_bytes``:
a msgpack map of nested maps whose leaves are arrays. This module decodes
what ``msgpack_restore`` reads and encodes what ``msgpack_serialize``
writes, in plain Python, so that the port needs neither flax nor the
``msgpack`` package (the card's machine has neither).

The format (msgpack, https://github.com/msgpack/msgpack/blob/master/spec.md,
with flax's extension types):

- ext 1, ndarray: the payload is a msgpack array ``(shape, dtype name,
  C-order bytes)``;
- ext 3, numpy scalar: the same payload, for a 0-d value;
- an array larger than ``MAX_CHUNK_SIZE`` bytes is written as the map
  ``{'__msgpack_chunked_array__': True, 'shape': {'0': d0, ...},
  'chunks': {'0': flat chunk, ...}}`` and joined again on reading.

``restore`` gives numpy arrays, and ``torch.bfloat16`` tensors for
``bfloat16`` (numpy has no such dtype). ``serialize`` takes maps with str
keys, lists, None, bool, int, float, str, bytes, numpy arrays and scalars
and torch tensors, and picks the smallest encoding of each value as
``msgpack-python`` does, so that its bytes equal flax's for the same tree.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
# flax's limit for one array leaf (flax.serialization.MAX_CHUNK_SIZE)
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ decode

class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw      # str as bytes (flax reads the ndarray payload so)

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        fixed = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                 0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sizes = {0: "B", 1: "H", 2: "I"}
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack(sizes[b - 0xC4]))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack(sizes[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(sizes[b - 0xDB]))]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(sizes[b - 0xDD]))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack(sizes[b - 0xC7]))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"map key of type {type(k).__name__}")
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(payload)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) \
                else arr[()]
        raise ValueError(f"unsupported msgpack ext type {code}: flax "
                         f"checkpoints hold only arrays (1) and numpy "
                         f"scalars (3)")


def _loads(data: bytes, raw: bool = False):
    r = _Reader(data, raw)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes")
    return out


def _array_from_payload(payload: bytes):
    shape, name, buf = _loads(payload, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(d):
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        return {k: _unchunk_tree(v) for k, v in d.items()}
    return d


def restore(data: bytes):
    """Bytes written by ``flax.serialization.msgpack_serialize`` (or
    ``to_bytes``) → the nested dicts that ``msgpack_restore`` returns."""
    return _unchunk_tree(_loads(data))


def load(path: str):
    """``restore`` of a file."""
    with open(path, "rb") as f:
        return restore(f.read())


# ------------------------------------------------------------------ encode

def _len_header(out: bytearray, n: int, fix: int | None, fix_max: int,
                codes: tuple[int, ...]) -> None:
    """A length prefix: ``fix | n`` up to ``fix_max``, then 8/16/32-bit
    forms from ``codes`` (None where the type has no 8-bit form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, ("B", "H", "I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    if v >= 0:
        for code, fmt, top in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF),
                               (0xCE, "I", 0xFFFFFFFF),
                               (0xCF, "Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(">" + fmt, v)
                return
    else:
        for code, fmt, bot in ((0xD0, "b", -0x80), (0xD1, "h", -0x8000),
                               (0xD2, "i", -0x80000000),
                               (0xD3, "q", -0x8000000000000000)):
            if v >= bot:
                out.append(code)
                out += struct.pack(">" + fmt, v)
                return
    raise ValueError(f"integer {v} does not fit in 64 bits")


def _array_payload(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name,
    C-order bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name = tuple(t.shape), "bfloat16"
            buf = t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, buf = a.shape, a.dtype.name, a.tobytes("C")
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not "
                             "serializable")
        shape, name, buf = arr.shape, arr.dtype.name, arr.tobytes("C")
    out = bytearray()
    _pack(out, [list(shape), name, buf])
    return bytes(out)


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _len_header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif type(v) is str:
        b = v.encode("utf-8")
        _len_header(out, len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
        out += b
    elif type(v) is bytes:
        _len_header(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif type(v) is dict:
        _len_header(out, len(v), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif type(v) in (list, tuple):
        _len_header(out, len(v), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _array_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(v)))
    else:
        raise TypeError(f"can not serialize {type(v).__name__!r} object")


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return v.size * v.dtype.itemsize


def _chunk(v) -> dict:
    """flax's ``_chunk``: a flat array in chunks of ``MAX_CHUNK_SIZE``
    bytes."""
    itemsize = v.element_size() if isinstance(v, torch.Tensor) \
        else v.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = v.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(v.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _chunk_tree(d):
    """Oversized array leaves of maps (and the root) → chunked maps, as
    flax's ``_chunk_array_leaves_in_place`` (which does not look into
    lists)."""
    if isinstance(d, dict):
        return {k: _chunk_tree(v) for k, v in d.items()}
    if isinstance(d, (np.ndarray, torch.Tensor)) and \
            _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for
    ``tree``."""
    out = bytearray()
    _pack(out, _chunk_tree(tree))
    return bytes(out)


def save(path: str, tree) -> None:
    """``serialize`` to a file."""
    with open(path, "wb") as f:
        f.write(serialize(tree))
