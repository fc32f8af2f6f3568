"""The msgpack layout of `flax.serialization.to_bytes`, without the
`msgpack` package (port of the codec half of
`madrona_basketball_tpu/utils/checkpoint.py:25-29,75-77`).

A `.ckpt` agent file of the JAX package is `msgpack.packb` of the agent's
flax state dict: nested maps with str keys whose leaves are arrays.
flax packs an array as msgpack ext type 1 whose payload is itself
`packb((shape, dtype name, C-order bytes))`, and a numpy scalar as ext
type 3 with the same payload (flax/serialization.py:249-299).  `packb`
and `unpackb` cover that subset of msgpack: maps, arrays, str, bin, ints,
floats, nil, bool and those two ext types.  flax splits an array of more
than 2**30 bytes into chunks; an agent holds none, and `unpackb` raises
on a chunked leaf.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple):
    """A length header: a fix form up to fix_max, else the 8 / 16 / 32-bit
    form (codes lists the first byte of each, None where msgpack has no
    such form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} is too large for msgpack")


def _pack_int(out: bytearray, x: int):
    if 0 <= x <= 0x7F:
        out.append(x)
    elif -32 <= x < 0:
        out += struct.pack(">b", x)
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= top:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise ValueError(f"int {x} is too large for msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if x >= lo:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise ValueError(f"int {x} is too small for msgpack")


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"dtype {a.dtype} cannot be packed")
    return packb((tuple(int(d) for d in a.shape), a.dtype.name,
                  a.tobytes("C")))


def _pack_ext(out: bytearray, code: int, data: bytes):
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _pack(out: bytearray, x):
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot pack {type(x).__name__}")


def packb(x) -> bytes:
    """msgpack bytes of `x` (flax's `msgpack_serialize` for trees whose
    leaves are numpy arrays, numpy scalars or Python scalars)."""
    out = bytearray()
    _pack(out, x)
    return bytes(out)


# ---------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype, buf = unpackb(data)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported")
    return np.frombuffer(bytes(buf), dtype=np.dtype(dtype)).reshape(
        tuple(shape), order="C").copy()


def _ext(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(bytes(data))
    if code == EXT_NPSCALAR:
        return _ndarray_from_payload(bytes(data))[()]
    raise ValueError(f"msgpack ext type {code} is not one flax writes for "
                     "an agent")


def _read(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    fmts = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fmts:
        return r.unpack(fmts[b])
    lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
            0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
            0xDC: ">H", 0xDD: ">I",                  # array
            0xDE: ">H", 0xDF: ">I",                  # map
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}      # ext
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        code = r.unpack(">b")
        return _ext(code, r.take(fixext[b]))
    if b not in lens:
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
    n = r.unpack(lens[b])
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(n))
    if b in (0xD9, 0xDA, 0xDB):
        return bytes(r.take(n)).decode("utf-8")
    if b in (0xDC, 0xDD):
        return [_read(r) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _read_map(r, n)
    code = r.unpack(">b")
    return _ext(code, r.take(n))


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    if _CHUNKED in out:
        raise ValueError("chunked array leaves (over 2**30 bytes) are not "
                         "supported")
    return out


def unpackb(data: bytes):
    """Inverse of `packb` (flax's `msgpack_restore`): ext-type-1 leaves
    become numpy arrays, ext-type-3 leaves numpy scalars."""
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack "
                         "object")
    return out
