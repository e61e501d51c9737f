"""Build and load the port's CUDA kernels.

Each source under ``eabnet_tpu_torch/csrc/`` is compiled by its own
``nvcc`` call, all started together, and the objects are linked into
``build/eabnet_tpu_torch/libeabnet_kernels.so`` beside the package, at
first use, and loaded with ``ctypes``. The library exposes a
plain C interface, so no PyTorch header is compiled and the build takes
seconds. It is rebuilt when the hash of the sources or of the command
changes; the new library is written under a temporary name and renamed
into place, so there is no lock file to go stale.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "eabnet_tpu_torch"
LIB_NAME = "libeabnet_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # C function -> (argtypes, restype)
    "eabnet_lstm_bf_fwd": ([_P] * 5 + [_I, _I, _P], _I),
    "eabnet_lstm_bf_fwd_bf16": ([_P] * 5 + [_I, _I, _P], _I),
    "eabnet_lstm_bf_fwd_train": ([_P] * 8 + [_I, _I, _P], _I),
    "eabnet_lstm_bf_fwd_train_bf16": ([_P] * 8 + [_I, _I, _P], _I),
    "eabnet_lstm_bf_fwd_lanes_per_block": ([_I], _I),
    "eabnet_lstm_bf_bwd_workspace": ([_I, _I], ctypes.c_longlong),
    "eabnet_lstm_bf_bwd": ([_P] * 13 + [_I, _I, _P], _I),
    "eabnet_lstm_bf_bwd_bf16": ([_P] * 13 + [_I, _I, _P], _I),
    "eabnet_tcm_chain_fwd": ([_P] * 10 + [_I] * 5 + [_P, _I, _P], _I),
    "eabnet_tcm_chain_fwd_bf16": ([_P] * 10 + [_I] * 5 + [_P, _I, _P], _I),
    "eabnet_tcm_chain_workspace": ([_I, _I], ctypes.c_longlong),
    "eabnet_tcm_chain_geometry": ([_I] * 6 + [_P], _I),
    "eabnet_tcm_chain_bwd_workspace": ([_I] * 7, ctypes.c_longlong),
    "eabnet_tcm_chain_bwd": ([_P] * 12 + [_I] * 5 + [_P, _I, _P], _I),
    "eabnet_tcm_chain_bwd_bf16": ([_P] * 12 + [_I] * 5 + [_P, _I, _P], _I),
    "eabnet_tcm_chain_bwd_offsets": ([_I] * 7 + [_P], _I),
    "eabnet_error_string": ([_I], ctypes.c_char_p),
}


@dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    built: bool         # False when an up-to-date library was reused
    seconds: float      # time of the nvcc call (0 when reused)
    log: str            # nvcc's output, with the -Xptxas -v resource lines

    def check(self, err: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if err != 0:
            msg = self.lib.eabnet_error_string(err).decode()
            raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with "
            "the CUDA toolkit (on PATH or under /usr/local/cuda)")
    return path


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


@functools.lru_cache(maxsize=1)
def load_library() -> Library:
    """Build (if the sources changed) and load the kernel library."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest(nvcc)
    built, seconds, log = False, 0.0, ""
    if not (lib_path.exists() and stamp.exists()
            and stamp.read_text() == digest):
        t0 = time.perf_counter()
        tmp_dir = tempfile.mkdtemp(dir=BUILD_DIR)
        try:
            cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o",
                     os.path.join(tmp_dir, src.stem + ".o"), str(src)]
                    for src in _sources() if src.suffix == ".cu"]
            cmds.append([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                         os.path.join(tmp_dir, LIB_NAME),
                         *[c[c.index("-o") + 1] for c in cmds]])
            logs = []
            for group in (cmds[:-1], cmds[-1:]):  # compile together, link
                procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True) for c in group]
                outs = [proc.communicate()[0] for proc in procs]
                logs += outs
                for cmd, proc, out in zip(group, procs, outs):
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed ({proc.returncode}):\n"
                            f"{' '.join(cmd)}\n{out}")
            log = "".join(logs)
            os.replace(os.path.join(tmp_dir, LIB_NAME), lib_path)
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)
        seconds = time.perf_counter() - t0
        stamp.write_text(digest)
        (BUILD_DIR / "nvcc.log").write_text(log)
        built = True
    elif (BUILD_DIR / "nvcc.log").exists():
        log = (BUILD_DIR / "nvcc.log").read_text()
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return Library(lib, lib_path, built, seconds, log)
