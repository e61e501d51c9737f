"""Checkpoints of the JAX package, read and written without flax or
msgpack.

``<iter>.params`` (and the ``params`` inside a full ``<iter>.ckpt``) is a
flax state dict serialized as msgpack, with each ndarray stored as msgpack
extension type 1 holding a nested msgpack ``(shape, dtype name, buffer)``
and each numpy scalar as type 3 in the same encoding. The reader below
decodes exactly that subset of msgpack: maps, arrays, str, bin, ints,
floats, nil/bool and those two extension types; a bfloat16 array (a
checkpoint of a bf16 tree) comes back as the float32 array of the same
values. The writer
(``msgpack_serialize``) emits what ``flax.serialization.to_bytes`` emits
for a tree of dicts and numpy arrays and scalars, byte for byte.
"""

from __future__ import annotations

import glob
import os
import re
import struct
import tempfile
import warnings
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
        # numpy has no bfloat16: a bfloat16 value is the high half of the
        # float32 with the same value, so the decode is exact
        arr = (np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
               ).view(np.float32).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr
    arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes):
    """Decode flax's msgpack serialization into dicts of numpy arrays."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _pack_len(out: bytearray, n: int, small: int, tags) -> None:
    """A length header: fixed form below ``small`` (tag | n), else the
    8/16/32-bit form of the three tags (None: that form does not exist)."""
    if small and n < small:
        out.append(tags[0] | n)
        return
    for tag, fmt, limit in zip(tags[1:], (">B", ">H", ">I"),
                               (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} too large for msgpack")
    else:
        for tag, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} too small for msgpack")


def _pack_array_payload(arr: np.ndarray) -> bytes:
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialised")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, x) -> None:
    if isinstance(x, np.ndarray):
        if x.nbytes > _MAX_CHUNK:
            raise ValueError("arrays above 1 GiB (flax chunks them) are not "
                             "written by this serialiser")
        code, data = _EXT_NDARRAY, _pack_array_payload(x)
    elif isinstance(x, np.generic):
        code, data = _EXT_NPSCALAR, _pack_array_payload(np.asarray(x))
    else:
        code = None
    if code is not None:
        n = len(data)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_len(out, n, 0, (0, 0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)
        out += data
    elif x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif type(x) is str:
        b = x.encode("utf-8")
        _pack_len(out, len(b), 32, (0xA0, 0xD9, 0xDA, 0xDB))
        out += b
    elif type(x) is bytes:
        _pack_len(out, len(x), 0, (0, 0xC4, 0xC5, 0xC6))
        out += x
    elif type(x) in (list, tuple):
        _pack_len(out, len(x), 16, (0x90, None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif type(x) is dict:
        _pack_len(out, len(x), 16, (0x80, None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


_MAX_CHUNK = 2 ** 30  # flax splits arrays above this into chunks


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts (str keys), lists, Python scalars and numpy
    arrays and scalars exactly as ``flax.serialization.to_bytes`` /
    ``msgpack_serialize`` do: ndarrays as extension type 1, numpy scalars
    as extension type 3, each holding msgpack (shape, dtype name, bytes);
    dicts in insertion order (an empty dict is an empty map)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def write_atomic(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` through a temporary file in the same
    directory and a rename, so a reader never sees half a file."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_params(path: str, model_cfg=None) -> dict:
    """The flax param tree ({"eabnet": ..., "postnet": ...}) of a
    ``.params`` release artifact, a full ``.ckpt`` training checkpoint or a
    reference ``.pth`` checkpoint; a ``.pth`` is converted for the
    ``ComposedConfig`` ``model_cfg`` (``utils/convert_torch.py``)."""
    if path.endswith(".pth"):
        if model_cfg is None:
            raise ValueError(f"{path}: a reference .pth checkpoint is "
                             "converted for a model config; pass model_cfg")
        from eabnet_tpu_torch.utils.convert_torch import \
            load_torch_checkpoint

        return load_torch_checkpoint(path, model_cfg)["params"]
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if "state" in tree:  # full training checkpoint
        tree = tree["state"]
    return tree["params"]


def latest_checkpoint(directory: str) -> Optional[str]:
    """Highest-iteration checkpoint in the directory, ranked as the JAX
    package ranks them: ``<iter>.ckpt``, reference ``<iter>.pth`` and
    params-only ``<iter>.params``; at one iteration a full ``.ckpt`` wins. Warns when a
    ``.params`` file outranks every ``.ckpt`` (resuming from it resets the
    optimizer)."""
    best, best_key = None, (-1, -1)
    for rank, ext in enumerate(("params", "pth", "ckpt")):
        for path in glob.glob(os.path.join(directory, f"*.{ext}")):
            m = re.match(rf"(\d+)\.{ext}$", os.path.basename(path))
            if m and (int(m.group(1)), rank) > best_key:
                best, best_key = path, (int(m.group(1)), rank)
    if (best is not None and best.endswith(".params")
            and glob.glob(os.path.join(directory, "*.ckpt"))):
        warnings.warn(
            f"auto-resume selected params-only {os.path.basename(best)} "
            f"over lower-iteration .ckpt files in {directory}; optimizer "
            f"state will be reinitialized", stacklevel=2)
    return best
