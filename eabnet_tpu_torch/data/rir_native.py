"""ctypes bindings for the port's C++ RIR engine (``native/rir.cpp``).

The engine does the image-source enumeration and the fractional-delay
scatter of :func:`eabnet_tpu_torch.data.rir.shoebox_rir` in C++, the
dominant host cost of online synthesis; the hybrid tails stay in numpy on
top, so both backends share one RNG stream.

It is built at first use with ``g++ -O3 -march=native -ffast-math -fPIC
-std=c++17 -shared`` into ``build/eabnet_tpu_torch/librir-<digest>.so``
beside the package. The digest covers the source, the command and the host
CPU (a ``-march=native`` library copied from another machine can die with
SIGILL), so a changed source, flag or CPU builds a new library. It is
written under a temporary name and renamed into place; there is no lock
file. A library whose ``rir_abi_version`` is not this binding's is
unloaded and rebuilt, never called.

``rir_backend`` (``DataConfig.rir_backend``) keeps the JAX package's
meaning: ``"native"`` raises if the engine cannot be built, ``"numpy"``
never uses it, ``"auto"`` prefers it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "rir.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "eabnet_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-std=c++17",
             "-shared")
ABI_VERSION = 2  # must match rir_abi_version() in native/rir.cpp
FDL = 81

_lib = None


def _cxx() -> str:
    return os.environ.get("CXX") or shutil.which("g++") or "g++"


def _host_cpu() -> str:
    """The CPU model and its feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            text = f.read()
    except OSError:
        import platform

        return platform.machine() + platform.processor()
    keep = [ln for ln in text.split("\n\n")[0].splitlines()
            if ln.split(":")[0].strip() in ("vendor_id", "model name",
                                            "flags", "Features")]
    return "\n".join(keep)


def library_path() -> Path:
    """Where the library for this source, command and host CPU lives."""
    h = hashlib.sha256(" ".join((_cxx(),) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"librir-{h.hexdigest()[:16]}.so"


def _open(path: Path):
    """dlopen ``path`` -> the library if its ABI version is ours, else None
    (and the handle closed, so a rebuilt file at the same path is opened
    afresh rather than found among the loaded objects by name)."""
    lib = ctypes.CDLL(str(path))
    try:
        ver = ctypes.CFUNCTYPE(ctypes.c_longlong)(("rir_abi_version", lib))()
    except AttributeError:
        ver = None
    if ver == ABI_VERSION:
        return lib
    import _ctypes

    _ctypes.dlclose(lib._handle)
    return None


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_dir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        tmp = os.path.join(tmp_dir, path.name)
        cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def load_library(path: Optional[Path] = None):
    """Build (if missing or of another ABI) and load the engine at
    ``path`` (default: ``library_path()``, loaded once per process);
    raises RuntimeError when it cannot be built."""
    global _lib
    if path is None:
        if _lib is None:
            _lib = load_library(library_path())
        return _lib
    lib = _open(path) if path.exists() else None
    if lib is None:
        try:
            _build(path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"native RIR engine not built: {e}") from e
        lib = _open(path)
        if lib is None:
            raise RuntimeError(f"{path} exports another rir_abi_version")
    lib.shoebox_rir.restype = ctypes.c_longlong
    lib.shoebox_rir.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # room[3]
        ctypes.POINTER(ctypes.c_double),  # src[3]
        ctypes.POINTER(ctypes.c_double),  # mics (M*3)
        ctypes.c_int,                     # M
        ctypes.c_double,                  # e_absorption
        ctypes.c_int,                     # max_order
        ctypes.c_int,                     # fs
        ctypes.c_double,                  # c
        ctypes.c_double,                  # air absorption (energy, 1/m)
        ctypes.POINTER(ctypes.c_float),   # out (M * max_len)
        ctypes.c_longlong,                # max_len
    ]
    return lib


def native_available() -> bool:
    """True once the engine is built and loaded (builds it if needed)."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def resolve_rir_fn(backend: str):
    """``rir_backend`` -> the RIR function: the native engine for "native"
    (or RuntimeError) and for "auto" when it builds, numpy otherwise."""
    from eabnet_tpu_torch.data.rir import shoebox_rir

    if backend == "native":
        load_library()
        return shoebox_rir_native
    if backend == "auto" and native_available():
        return shoebox_rir_native
    return shoebox_rir


def shoebox_rir_native(
    room_dim: Sequence[float],
    src: Sequence[float],
    mics: np.ndarray,
    e_absorption: float,
    max_order: int,
    fs: int,
    method: str = "ism",
    rt60: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
    c: float = 343.0,
    air_absorption: Optional[float] = None,
) -> np.ndarray:
    """Drop-in replacement for :func:`eabnet_tpu_torch.data.rir.shoebox_rir`:
    the image sources in C++, the hybrid tails in numpy on top."""
    from eabnet_tpu_torch.data.rir import (add_histogram_tail,
                                           apply_diffuse_tail,
                                           resolve_rir_method)

    lib = load_library()
    room = np.ascontiguousarray(np.asarray(room_dim, np.float64))
    src_a = np.ascontiguousarray(np.asarray(src, np.float64))
    mics = np.atleast_2d(np.asarray(mics, np.float64))
    if mics.shape[0] == 3 and mics.shape[1] != 3:
        mics = mics.T
    mics_a = np.ascontiguousarray(mics)
    m = mics_a.shape[0]

    ism_order, air_absorption, hybrid_hist = resolve_rir_method(
        method, max_order, rt60, air_absorption)

    # upper bound on the RIR length: farthest image + filter length
    diag = float(np.linalg.norm(room))
    max_dist = diag * (ism_order + 1) + float(
        np.linalg.norm(src_a) + np.abs(mics_a).sum())
    max_len = int(max_dist * fs / c) + FDL + 8

    out = np.zeros((m, max_len), np.float32)
    used = lib.shoebox_rir(
        room.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        src_a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        mics_a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m, float(e_absorption), int(ism_order), int(fs), float(c),
        float(air_absorption),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_len)
    if used <= 0:
        raise RuntimeError("native RIR engine overflowed its buffer")
    out = out[:, :used]

    if hybrid_hist:
        out = add_histogram_tail(
            out, np.asarray(room_dim, np.float64), src_a, mics_a,
            e_absorption, ism_order, rt60, fs, rng, c, air_absorption)
    elif method == "hybrid-sabine" and rt60 is not None and max_order > 3:
        # used = max(floor(delay)) + FDL//2 + 1 -> the farthest image
        # distance, the tail's switch point
        max_dist = (used - FDL // 2 - 1) * c / fs
        out = apply_diffuse_tail(
            out, max_dist, rt60, fs, rng, c,
            volume=float(np.prod(np.asarray(room_dim, np.float64))))
    return out
