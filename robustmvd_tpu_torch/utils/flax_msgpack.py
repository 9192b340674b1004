"""A reader of flax's msgpack files, in plain Python (``struct``, numpy, torch).

The JAX package's trainer writes its weights-only snapshots with
``flax.serialization.to_bytes`` (``snapshot-iter-{:09d}.msgpack``): a
msgpack document of nested maps with str keys whose leaves are msgpack
extension objects. The port reads them without the ``msgpack`` package or
flax. It decodes the subset that ``flax.serialization.msgpack_serialize``
writes:

- maps with str keys; arrays; str, bin, int, float, bool and nil;
- ext 1: an ndarray, a nested msgpack array ``[shape, dtype name, C-order
  bytes]``; ext 3: a numpy scalar packed the same way; ext 2: a complex
  number, a nested ``[real, imag]``;
- flax's chunked leaves, ``{"__msgpack_chunked_array__": True, "shape":
  {"0": ...}, "chunks": {"0": ...}}`` (written above flax's
  ``MAX_CHUNK_SIZE``), rejoined into one array.

Arrays come back as numpy arrays (read-only views of the file's bytes, as
flax's are), except ``bfloat16`` leaves: numpy has no such dtype without
``ml_dtypes``, so they are read as uint16 and come back as
``torch.bfloat16`` tensors. Anything outside the subset (another ext code,
a map key that is not a str, a dtype numpy does not know, a truncated
document or bytes after its end) raises ``ValueError`` naming what was
found.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"

# first byte -> (kind, struct format of the length or value that follows)
_FIXED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xCA: ("value", ">f"), 0xCB: ("value", ">d"),
    0xCC: ("value", ">B"), 0xCD: ("value", ">H"), 0xCE: ("value", ">I"), 0xCF: ("value", ">Q"),
    0xD0: ("value", ">b"), 0xD1: ("value", ">h"), 0xD2: ("value", ">i"), 0xD3: ("value", ">q"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n, what):
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack: {what} needs {n} bytes at offset {self.pos}, "
                             f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt, what):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt), what))[0]

    def obj(self):
        at = self.pos
        b = self.unpack(">B", "a type byte")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _FIXEXT:
            return self.ext(self.unpack(">b", "an ext code"), _FIXEXT[b])
        if b not in _FIXED:
            raise ValueError(f"msgpack type byte 0x{b:02x} at offset {at} is not one flax writes")
        kind, fmt = _FIXED[b]
        n = self.unpack(fmt, kind)
        if kind == "value":
            return n
        if kind == "bin":
            return bytes(self.take(n, "bin"))
        if kind == "str":
            return self.str(n)
        if kind == "array":
            return [self.obj() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(self.unpack(">b", "an ext code"), n)

    def str(self, n):
        raw = self.take(n, "str")
        try:
            return str(raw, "utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack str at offset {self.pos - n} is not UTF-8: {e}") from None

    def map(self, n):
        out = {}
        for _ in range(n):
            at = self.pos
            key = self.obj()
            if not isinstance(key, str):
                raise ValueError(f"msgpack map key at offset {at} is {type(key).__name__} {key!r}, not a str")
            out[key] = self.obj()
        return out

    def ext(self, code, n):
        payload = self.take(n, f"ext {code}")
        if code == 1:
            return _ndarray(payload)
        if code == 3:
            return _ndarray(payload)[()]
        if code == 2:
            parts = _decode(payload)
            if not (isinstance(parts, list) and len(parts) == 2):
                raise ValueError(f"msgpack ext 2 (complex) holds {parts!r}, not [real, imag]")
            return complex(parts[0], parts[1])
        raise ValueError(f"msgpack ext code {code} is not one flax writes (1 ndarray, 2 complex, 3 numpy scalar)")


def _decode(data):
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the end of the document")
    return out


def _ndarray(payload):
    """flax's ``_ndarray_from_bytes``: [shape, dtype name, C-order bytes]."""
    parts = _decode(payload)
    if not (isinstance(parts, list) and len(parts) == 3 and isinstance(parts[0], list)
            and isinstance(parts[1], str) and isinstance(parts[2], bytes)):
        raise ValueError(f"msgpack ext 1 (ndarray) holds {type(parts).__name__}, not [shape, dtype name, bytes]")
    shape, name, buffer = parts
    if not all(isinstance(n, int) and n >= 0 for n in shape):
        raise ValueError(f"ndarray shape {shape!r}")
    bf16 = name == "bfloat16"
    try:
        dtype = np.dtype(np.uint16 if bf16 else name)
    except TypeError:
        raise ValueError(f"ndarray dtype {name!r} is not one numpy knows") from None
    if dtype.hasobject or len(buffer) != int(np.prod(shape)) * dtype.itemsize:
        raise ValueError(f"ndarray of shape {shape} and dtype {name} in {len(buffer)} bytes")
    array = np.frombuffer(buffer, dtype=dtype).reshape(shape)
    return torch.from_numpy(array.copy()).view(torch.bfloat16) if bf16 else array


def _unchunk(node):
    if not isinstance(node, dict):
        return node
    if CHUNKED in node:
        try:
            shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        except (KeyError, TypeError) as e:
            raise ValueError(f"malformed chunked array leaf: {e!r}") from None
        if chunks and isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def msgpack_restore(data):
    """flax's ``msgpack_restore``: msgpack bytes -> the tree they hold."""
    return _unchunk(_decode(data))


def read(path):
    """The tree of a flax msgpack file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
