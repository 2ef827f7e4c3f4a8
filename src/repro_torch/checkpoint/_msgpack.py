"""A msgpack codec for the subset that checkpoints use.

`packb(obj)` gives the bytes of `msgpack.packb(obj, use_bin_type=True)` and
`unpackb(data)` the value of `msgpack.unpackb(data, raw=False,
strict_map_key=False)` for maps, arrays (lists and tuples; arrays unpack as
lists), str, int (every width msgpack has), float (float64; float32 is read
too), bool, None and bin (bytes). It follows msgpack's rules: the smallest
int format, str8/16/32, bin8/16/32, fixmap/map16/map32 and
fixarray/array16/array32. Anything else raises TypeError when packed, and
data outside the subset (ext types, a reserved byte, trailing or missing
bytes) raises `UnpackError` when unpacked. The port keeps its own codec so
that it needs no package beyond torch and numpy.
"""
from __future__ import annotations

import struct


class UnpackError(ValueError):
    """The bytes are not msgpack of the checkpoint subset."""


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return b"\xcc" + struct.pack(">B", n)
    if -0x80 <= n < 0:
        return b"\xd0" + struct.pack(">b", n)
    if 0xFF < n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if -0x8000 <= n < -0x80:
        return b"\xd1" + struct.pack(">h", n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    if -0x80000000 <= n < -0x8000:
        return b"\xd2" + struct.pack(">i", n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", n)
    if -0x8000000000000000 <= n < -0x80000000:
        return b"\xd3" + struct.pack(">q", n)
    raise OverflowError("Integer value out of range")


def _header(n: int, fix: int, fix_max: int, codes: tuple[bytes, bytes, bytes],
            kind: str) -> bytes:
    """Length header: a fix format below `fix_max`, else 8/16/32-bit lengths
    (`codes`; an empty code means that width does not exist)."""
    if n < fix_max:
        return bytes((fix | n,))
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            return code + struct.pack(fmt, n)
    raise ValueError(f"{kind} is too large")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_header(len(raw), 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"), "str"))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_header(len(raw), 0, 0, (b"\xc4", b"\xc5", b"\xc6"), "bin"))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, (b"", b"\xdc", b"\xdd"), "array"))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, (b"", b"\xde", b"\xdf"), "map"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# Fixed-width formats: first byte -> (struct format, byte count).
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# Length-prefixed formats: first byte -> (kind, length format, length bytes).
_SIZED = {
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise UnpackError("truncated msgpack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.sized("str", b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self.sized("array", b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self.sized("map", b & 0x0F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return struct.unpack(fmt, self.take(n))[0]
        if b in _SIZED:
            kind, fmt, n = _SIZED[b]
            return self.sized(kind, struct.unpack(fmt, self.take(n))[0])
        raise UnpackError(f"msgpack type byte {b:#04x} is outside the checkpoint subset")

    def sized(self, kind: str, n: int):
        if kind == "str":
            try:
                return str(self.take(n), "utf-8")
            except UnicodeDecodeError as exc:
                raise UnpackError(f"invalid utf-8 in a str: {exc}") from exc
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.value()
            try:
                out[k] = self.value()
            except TypeError as exc:  # an unhashable key
                raise UnpackError(f"unhashable map key: {exc}") from exc
        return out


def unpackb(data: bytes):
    r = _Reader(data)
    obj = r.value()
    if r.pos != len(r.data):
        raise UnpackError(f"{len(r.data) - r.pos} bytes of extra data after the value")
    return obj
