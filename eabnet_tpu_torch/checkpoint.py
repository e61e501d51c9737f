"""Checkpoints of the JAX package, read without flax or msgpack.

``<iter>.params`` (and the ``params`` inside a full ``<iter>.ckpt``) is a
flax state dict serialized as msgpack, with each ndarray stored as msgpack
extension type 1 holding a nested msgpack ``(shape, dtype name, buffer)``
and each numpy scalar as type 3 in the same encoding. The reader below
decodes exactly that subset of msgpack: maps, arrays, str, bin, ints,
floats, nil/bool and those two extension types.
"""

from __future__ import annotations

import glob
import os
import re
import struct
from typing import Optional

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax packs dtype names that way)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _decode_ext(code, bytes(self.take(n)))

    def read(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # tag: (length format, decoder)
            0xC4: (">B", lambda n: bytes(self.take(n))),
            0xC5: (">H", lambda n: bytes(self.take(n))),
            0xC6: (">I", lambda n: bytes(self.take(n))),
            0xC7: (">B", self.ext), 0xC8: (">H", self.ext),
            0xC9: (">I", self.ext),
            0xD9: (">B", self.str_), 0xDA: (">H", self.str_),
            0xDB: (">I", self.str_),
            0xDC: (">H", lambda n: [self.read() for _ in range(n)]),
            0xDD: (">I", lambda n: [self.read() for _ in range(n)]),
            0xDE: (">H", self.map_), 0xDF: (">I", self.map_),
        }
        if b in sized:
            fmt, fn = sized[b]
            return fn(self.unpack(fmt))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"unsupported msgpack tag 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _decode_ext(code: int, data: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack extension type {code}")
    shape, dtype, buf = _Reader(data, raw=True).read()
    if dtype == b"bfloat16":
        raise NotImplementedError("bfloat16 checkpoints: the port runs "
                                  "float32 only in this slice")
    arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes):
    """Decode flax's msgpack serialization into dicts of numpy arrays."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_params(path: str) -> dict:
    """The flax param tree ({"eabnet": ..., "postnet": ...}) of a
    ``.params`` release artifact or a full ``.ckpt`` training checkpoint."""
    if path.endswith(".pth"):
        raise NotImplementedError(
            "reference .pth checkpoints are not read by this slice of the "
            "port; convert them with the JAX package first")
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if "state" in tree:  # full training checkpoint
        tree = tree["state"]
    return tree["params"]


def latest_checkpoint(directory: str) -> Optional[str]:
    """Highest-iteration ``<iter>.ckpt`` or ``<iter>.params`` in the
    directory; a full ``.ckpt`` wins over a ``.params`` of the same
    iteration, as in the JAX package."""
    best, best_key = None, (-1, -1)
    for rank, ext in enumerate(("params", "ckpt")):
        for path in glob.glob(os.path.join(directory, f"*.{ext}")):
            m = re.match(rf"(\d+)\.{ext}$", os.path.basename(path))
            if m and (int(m.group(1)), rank) > best_key:
                best, best_key = path, (int(m.group(1)), rank)
    return best
