"""Reader and writer of the msgpack that ``flax.serialization`` writes, with
no ``msgpack`` or ``flax`` package: the latency predictors'
``*_predictor.msgpack`` weights (nas/speed_model.py).

The subset: maps with string keys, strings, arrays, ints, floats, nil and
booleans, bin8 / bin16 / bin32, and ext type 1, flax's ndarray, whose
payload is itself the msgpack array ``(shape, dtype name, raw C-order
bytes)``. ``packb`` picks the smallest encoding of every value, as
``msgpack.packb`` does, so ``packb(unpackb(b)) == b`` for a file flax wrote.
"""

import struct

import numpy as np

EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return bytes(out)

    def unpack(self, fmt):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
                 0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
                 0xDC: ("array", "H"), 0xDD: ("array", "I"), 0xDE: ("map", "H"), 0xDF: ("map", "I"),
                 0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I")}
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b not in sized:
            raise ValueError(f"msgpack: type byte 0x{b:02x} is outside the subset flax writes")
        kind, fmt = sized[b]
        n = self.unpack(fmt)
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.take(n).decode("utf-8")
        return getattr(self, kind)(n)

    def map(self, n):
        return {self.value(): self.value() for _ in range(n)}

    def array(self, n):
        return [self.value() for _ in range(n)]

    def ext(self, n):
        code = self.unpack("b")
        payload = self.take(n)
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack: ext type {code} is not flax's ndarray (1)")
        shape, dtype, raw = unpackb(payload)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpackb(data):
    """Decode one msgpack value; ext type 1 becomes a numpy array."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return out


def _sized(out, n, small, codes, fmt_for_code):
    """The header of a value of length ``n``: a fix- form when ``small`` is
    not None and n < its limit, else the first of ``codes`` whose length
    field holds n."""
    if small is not None and n < small[1]:
        out.append(bytes([small[0] | n]))
        return
    for code, fmt in zip(codes, fmt_for_code):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(bytes([code]) + struct.pack(">" + fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


def _int(out, v):
    if 0 <= v <= 0x7F:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(bytes([v + 0x100]))
    elif v >= 0:
        for code, fmt in ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                out.append(bytes([code]) + struct.pack(">" + fmt, v))
                return
        raise ValueError(f"msgpack: int {v} too large")
    else:
        for code, fmt in ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(bytes([code]) + struct.pack(">" + fmt, v))
                return
        raise ValueError(f"msgpack: int {v} too small")


def _pack(out, v):
    if v is None or isinstance(v, bool):
        out.append(bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[v]]))
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _sized(out, len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB), "BHI")
        out.append(raw)
    elif isinstance(v, (bytes, bytearray)):
        _sized(out, len(v), None, (0xC4, 0xC5, 0xC6), "BHI")
        out.append(bytes(v))
    elif isinstance(v, (list, tuple)):
        _sized(out, len(v), (0x90, 16), (0xDC, 0xDD), "HI")
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _sized(out, len(v), (0x80, 16), (0xDE, 0xDF), "HI")
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, np.ndarray):
        arr = np.ascontiguousarray(v)
        payload = packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(bytes([fixext[n]]))
        else:
            _sized(out, n, None, (0xC7, 0xC8, 0xC9), "BHI")
        out.append(struct.pack(">b", EXT_NDARRAY) + payload)
    else:
        raise TypeError(f"msgpack: cannot pack {type(v).__name__}")


def packb(value):
    """Encode ``value`` (dicts, lists, tuples, str, bytes, int, float, None,
    bool, numpy arrays as ext type 1) in the smallest encodings."""
    out = []
    _pack(out, value)
    return b"".join(out)
