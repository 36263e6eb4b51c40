"""The msgpack subset the system's blobs and frames use, in pure Python.

The reference packs its checkpoint blob (``{"version", "entries"}``) and
its ``c_msg_test`` metrics frame with ``msgpack.packb(...,
use_bin_type=True)``.  The port writes the same bytes without the
``msgpack`` package: maps (insertion order), arrays, str, bin, int,
float (always float64, as ``packb`` writes a Python float), bool and
nil, each in the smallest encoding ``packb`` would choose;
:func:`pack_segments` packs the same bytes with the contents of chosen
``bin`` values left out, for a caller that writes them itself.  ``unpackb``
reads that subset back, with str decoded as UTF-8 and bin returned as a
``memoryview`` into the input (no copy of large payloads), and raises
:class:`MsgpackError` on anything else: an unknown type byte, a
truncated value, or bytes left over after the top-level object.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, List, Tuple

_U8 = struct.Struct(">B")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_I8 = struct.Struct(">b")
_I16 = struct.Struct(">h")
_I32 = struct.Struct(">i")
_I64 = struct.Struct(">q")
_F32 = struct.Struct(">f")
_F64 = struct.Struct(">d")


class MsgpackError(ValueError):
    """Bytes that are not a complete msgpack object of the subset."""


class Hole:
    """A ``bin`` of ``nbytes`` bytes whose contents :func:`pack_segments`
    leaves out: its header is packed, its bytes are the caller's."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int) -> None:
        self.nbytes = nbytes


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def _pack_int(v: int, out: List[bytes]) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(bytes((v,)))
        elif v <= 0xFF:
            out.append(b"\xcc" + bytes((v,)))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + _U16.pack(v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + _U32.pack(v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _U64.pack(v))
        else:
            raise OverflowError(f"int {v} too large for msgpack")
    elif v >= -32:
        out.append(bytes((v & 0xFF,)))
    elif v >= -0x80:
        out.append(b"\xd0" + _I8.pack(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _I16.pack(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _I32.pack(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _I64.pack(v))
    else:
        raise OverflowError(f"int {v} too small for msgpack")


def _pack_len(n: int, fix_base: int, fix_max: int, codes: Tuple[int, int, int],
              out: List[bytes]) -> None:
    """Header of a str/bin/array/map of length ``n``; ``codes`` are the
    8-, 16- and 32-bit length forms (0 where the family has none)."""
    c8, c16, c32 = codes
    if fix_max and n <= fix_max:
        out.append(bytes((fix_base | n,)))
    elif c8 and n <= 0xFF:
        out.append(bytes((c8, n)))
    elif n <= 0xFFFF:
        out.append(bytes((c16,)) + _U16.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(bytes((c32,)) + _U32.pack(n))
    else:
        raise OverflowError(f"length {n} too large for msgpack")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        _pack_len(n, 0, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(obj if isinstance(obj, bytes) else bytes(obj))
    elif isinstance(obj, Hole):
        _pack_len(obj.nbytes, 0, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (0, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (0, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """The bytes ``msgpack.packb(obj, use_bin_type=True)`` gives."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def pack_segments(obj: Any) -> List[bytes]:
    """``packb(obj)`` cut at each :class:`Hole` in ``obj``: the packed
    bytes before the first hole, between each hole and the next, and after
    the last, so one more segment than holes.  Laid out with each hole's
    ``nbytes`` bytes between its two segments they are the bytes
    ``packb`` gives for the same object with those bytes in place."""
    out: List[Any] = []
    _pack(obj, out)
    segments: List[bytes] = []
    start = 0
    for i, part in enumerate(out):
        if isinstance(part, Hole):
            segments.append(b"".join(out[start:i]))
            start = i + 1
    segments.append(b"".join(out[start:]))
    return segments


# ---------------------------------------------------------------------------
# Unpacking
# ---------------------------------------------------------------------------

class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, data: Any) -> None:
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(
                f"truncated: need {n} bytes at offset {self.pos}, "
                f"have {len(self.buf) - self.pos}"
            )
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, s: struct.Struct) -> Any:
        return s.unpack(self.take(s.size))[0]


def _str(r: _Reader, n: int) -> str:
    try:
        return str(r.take(n), "utf-8")
    except UnicodeDecodeError as exc:
        raise MsgpackError(f"invalid utf-8 in str: {exc}") from exc


def _array(r: _Reader, n: int) -> List[Any]:
    return [_unpack(r) for _ in range(n)]


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        try:
            out[k] = _unpack(r)
        except TypeError as exc:
            raise MsgpackError(f"unhashable map key {k!r}") from exc
    return out


_FIXED: dict = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: r.take(r.unpack(_U8)),
    0xC5: lambda r: r.take(r.unpack(_U16)),
    0xC6: lambda r: r.take(r.unpack(_U32)),
    0xCA: lambda r: r.unpack(_F32),
    0xCB: lambda r: r.unpack(_F64),
    0xCC: lambda r: r.unpack(_U8),
    0xCD: lambda r: r.unpack(_U16),
    0xCE: lambda r: r.unpack(_U32),
    0xCF: lambda r: r.unpack(_U64),
    0xD0: lambda r: r.unpack(_I8),
    0xD1: lambda r: r.unpack(_I16),
    0xD2: lambda r: r.unpack(_I32),
    0xD3: lambda r: r.unpack(_I64),
    0xD9: lambda r: _str(r, r.unpack(_U8)),
    0xDA: lambda r: _str(r, r.unpack(_U16)),
    0xDB: lambda r: _str(r, r.unpack(_U32)),
    0xDC: lambda r: _array(r, r.unpack(_U16)),
    0xDD: lambda r: _array(r, r.unpack(_U32)),
    0xDE: lambda r: _map(r, r.unpack(_U16)),
    0xDF: lambda r: _map(r, r.unpack(_U32)),
}


def _unpack(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(r, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        return _str(r, b & 0x1F)
    fn: Callable[[_Reader], Any] = _FIXED.get(b)  # type: ignore[assignment]
    if fn is None:
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x} at offset {r.pos - 1}")
    return fn(r)


def unpackb(data: Any) -> Any:
    """Decode one msgpack object that fills ``data`` exactly."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} bytes of extra data after the object")
    return obj
