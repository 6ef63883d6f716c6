"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc`` for ``sm_90a`` into a shared library, then loaded with
``ctypes``. The library's file name carries a hash of the source, the
shared headers ``csrc/*.cuh`` and the flags, so a changed source is
rebuilt and an unchanged one is reused.
The build directory is ``wavenet_torch/build/`` unless the environment
variable ``WAVENET_TORCH_BUILD_DIR`` names another.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()                      # guards _LIBS, BUILD_INFO
#: name -> {"seconds": build time (0.0 when reused), "log": nvcc output}
BUILD_INFO: Dict[str, dict] = {}


def build_dir() -> str:
    return os.environ.get("WAVENET_TORCH_BUILD_DIR",
                          os.path.join(_PKG, "build"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "",
            "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the wavenet_torch CUDA kernels")


def _compile(name: str):
    """Build ``csrc/<name>.cu`` unless its hashed library exists; load it.
    Two threads that build one source at once each write a temporary file
    and rename it over the same library, so either result is whole."""
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # The source and every header it may include from csrc/.
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"lib{name}-{digest}.so")
    info = {"seconds": 0.0, "log": "", "path": lib_path}
    if not os.path.exists(lib_path):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        t = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed to build {src}:\n"
                               + info["log"])
        os.replace(tmp, lib_path)
    return ctypes.CDLL(lib_path), info


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library.
    The build runs outside the lock, so different sources build in
    parallel when loaded from several threads."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
    lib, info = _compile(name)
    with _LOCK:
        BUILD_INFO.setdefault(name, info)
        return _LIBS.setdefault(name, lib)
