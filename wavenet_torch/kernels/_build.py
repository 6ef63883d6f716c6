"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc`` for ``sm_90a`` into a shared library, then loaded with
``ctypes``. The library's file name carries a hash of the source and the
flags, so a changed source is rebuilt and an unchanged one is reused.
The build directory is ``wavenet_torch/build/`` unless the environment
variable ``WAVENET_TORCH_BUILD_DIR`` names another.
"""

from __future__ import annotations

import ctypes
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
_LOCK = threading.Lock()
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


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(CSRC, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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
        lib = ctypes.CDLL(lib_path)
        BUILD_INFO[name] = info
        _LIBS[name] = lib
        return lib
