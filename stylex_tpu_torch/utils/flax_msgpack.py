"""flax's msgpack format, read and written without ``msgpack`` or ``flax``.

The JAX package stores its checkpoints (``model_<n>.ckpt``) and its weight
trees (``.msgpack``) with ``flax.serialization.msgpack_serialize``: a
msgpack map of nested maps whose leaves are arrays as msgpack extension
type 1, holding a nested msgpack array ``(shape, dtype name, C-order
bytes)``. Extension 2 is a Python complex (a packed ``(real, imag)``) and 3
a numpy scalar (packed as a 0-d array). A leaf over :data:`MAX_CHUNK_SIZE`
bytes is stored as ``{"__msgpack_chunked_array__": True, "shape": {"0":
...}, "chunks": {"0": flat chunk, ...}}``.

:func:`msgpack_restore` returns nested dicts whose array leaves are numpy
arrays that view the given buffer (no copy), and ``bfloat16`` leaves
``torch.bfloat16`` tensors, since numpy has no such dtype without
``ml_dtypes``. :func:`load` reads a file into one writable buffer, so its
leaves can be placed with a single copy. :func:`msgpack_serialize` and
:func:`dump` write numpy arrays, torch tensors (any device), numpy and
Python scalars, strings, bytes, lists and dicts; what they write,
``flax.serialization.msgpack_restore`` reads.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, List, Union

import numpy as np
import torch

__all__ = ["msgpack_restore", "msgpack_serialize", "load", "dump", "MAX_CHUNK_SIZE"]

# flax's limit: leaves above it are split into chunks of this many bytes
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

Buffer = Union[bytes, bytearray, memoryview]


# ----------------------------------------------------------------- decoding


class _Reader:
    def __init__(self, buf: Buffer):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self, raw: bool = False):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.read(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            return self._ext(self.unpack(">b"), self.take(n))
        if b in (0xCA, 0xCB):
            return self.unpack(">f" if b == 0xCA else ">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return self._ext(code, self.take(1 << (b - 0xD4)))
        if 0xD9 <= b <= 0xDB:
            return self._str(self.unpack((">B", ">H", ">I")[b - 0xD9]), raw)
        if b in (0xDC, 0xDD):
            return [self.read(raw) for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not valid")

    def _str(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def _map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.read(raw)
            out[key] = self.read(raw)
        return out

    def _ext(self, code: int, data: memoryview):
        if code == _EXT_NDARRAY:
            return _array_from(data)
        if code == _EXT_NPSCALAR:
            arr = _array_from(data)
            return arr.reshape(()).clone() if torch.is_tensor(arr) else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).read()
            return complex(real, imag)
        raise ValueError(f"msgpack extension type {code} is not one flax writes")


def _array_from(data: memoryview):
    """An ext-1 payload -> a numpy array (or, for bfloat16, a torch tensor)
    that views ``data``."""
    r = _Reader(data)
    shape, name, buf = _read_array_header(r)
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        if len(buf) == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        if buf.readonly:  # torch tensors cannot view read-only memory
            buf = bytearray(buf)
        return torch.frombuffer(buf, dtype=torch.int16).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _read_array_header(r: _Reader):
    """The nested ``(shape, dtype name, bytes)`` triple; the bytes as a
    view."""
    b = r.unpack(">B")
    if b != 0x93:
        raise ValueError("a flax ndarray extension must hold a 3-element array")
    shape = r.read()
    name = r.read(raw=True).decode("ascii")
    kind = r.unpack(">B")
    if kind not in (0xC4, 0xC5, 0xC6):
        raise ValueError("a flax ndarray extension must hold its data as bin")
    n = r.unpack((">B", ">H", ">I")[kind - 0xC4])
    return shape, name, r.take(n)


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(int(tree["shape"][str(i)]) for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            flat = (torch.cat(chunks) if torch.is_tensor(chunks[0]) else np.concatenate(chunks))
            return flat.reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(encoded: Buffer) -> Any:
    """flax msgpack bytes -> nested dicts (lists for msgpack arrays) of
    numpy arrays viewing ``encoded`` (torch tensors for ``bfloat16``),
    numbers, strings and bytes. Chunked leaves come back whole."""
    r = _Reader(encoded)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)


def load(path: Union[str, Path]) -> Any:
    """:func:`msgpack_restore` of a file, read once into a writable buffer
    that the array leaves view. Raises ``FileNotFoundError`` when the file
    does not exist."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"msgpack file not found: {path}")
    size = p.stat().st_size
    buf = bytearray(size)
    with open(p, "rb") as f:
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    return msgpack_restore(buf)


# ----------------------------------------------------------------- encoding


def _header(small: int, codes, n: int) -> bytes:
    """A length-prefixed msgpack header: the fix form below ``small`` (if
    any), else the 8/16/32-bit form from ``codes``."""
    if small and n < small:
        return bytes([codes[0] | n])
    for code, fmt, limit in zip(codes[1:], (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _int(n: int) -> bytes:
    if 0 <= n < 0x80 or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < limit:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -limit:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _str_bytes(s: str) -> bytes:
    data = s.encode("utf-8")
    return _header(32, (0xA0, 0xD9, 0xDA, 0xDB), len(data)) + data


def _ext(code: int, parts: List) -> List:
    n = sum(len(p) for p in parts)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _header(0, (None, 0xC7, 0xC8, 0xC9), n)
    return [head + struct.pack(">b", code), *parts]


def _array_parts(shape, name: str, data: memoryview) -> List:
    """The nested ``(shape, dtype name, bytes)`` msgpack of one array:
    a header and the data itself, not copied."""
    head = [b"\x93", _header(16, (0x90, None, 0xDC, 0xDD), len(shape))]
    head += [_int(int(s)) for s in shape]
    head += [_str_bytes(name), _header(0, (None, 0xC4, 0xC5, 0xC6), len(data))]
    return [b"".join(head), data]


def _host_array(x):
    """A numpy array or torch tensor -> (shape, dtype name, C-order bytes
    as a memoryview)."""
    if torch.is_tensor(x):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", memoryview(t.view(torch.int16).numpy()).cast("B")
        x = t.numpy()
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:  # (np.ascontiguousarray turns 0-d into 1-d)
        arr = arr.copy(order="C")
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes cannot be serialized")
    data = memoryview(arr.reshape(-1)).cast("B") if arr.size else memoryview(b"")
    return arr.shape, arr.dtype.name, data


def _chunk(x) -> dict:
    flat = x.reshape(-1)
    itemsize = flat.element_size() if torch.is_tensor(flat) else flat.dtype.itemsize
    step = max(1, MAX_CHUNK_SIZE // itemsize)
    n = flat.shape[0]
    return {_CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + step] for j, i in enumerate(range(0, n, step))}}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if torch.is_tensor(x) else x.nbytes


def _pack(obj, out: List) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        out.append(_str_bytes(obj))
    elif isinstance(obj, (bytes, bytearray)):
        out += [_header(0, (None, 0xC4, 0xC5, 0xC6), len(obj)), bytes(obj)]
    elif isinstance(obj, dict):
        out.append(_header(16, (0x80, None, 0xDE, 0xDF), len(obj)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(16, (0x90, None, 0xDC, 0xDD), len(obj)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out)
        else:
            out += _ext(_EXT_NDARRAY, _array_parts(*_host_array(obj)))
    elif isinstance(obj, np.generic):
        out += _ext(_EXT_NPSCALAR, _array_parts(*_host_array(np.asarray(obj))))
    elif isinstance(obj, complex):
        out += _ext(_EXT_COMPLEX, [b"\x92\xcb" + struct.pack(">d", obj.real)
                                   + b"\xcb" + struct.pack(">d", obj.imag)])
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} in flax's msgpack format")


def msgpack_serialize(tree: Any) -> bytes:
    """A tree of dicts, lists, scalars, strings, bytes and arrays (numpy
    or torch, any device) -> flax msgpack bytes."""
    parts: List = []
    _pack(tree, parts)
    return b"".join(parts)


def dump(tree: Any, path: Union[str, Path]) -> int:
    """Write :func:`msgpack_serialize`'s bytes to ``path`` through a
    temporary file and a rename (a reader never sees half a file), without
    first joining them in memory. Returns the size in bytes."""
    parts: List = []
    _pack(tree, parts)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    with open(tmp, "wb") as f:
        for part in parts:
            f.write(part)
    tmp.replace(p)
    return p.stat().st_size
