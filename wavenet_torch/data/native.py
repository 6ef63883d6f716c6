"""ctypes bindings for the native data-path library (``native/wavenet_data.cpp``).

Counterpart of ``wavenet_tpu/data/native.py``: wav decode, polyphase
resample, RMS silence trim and the mu-law codec in C++, which the reader
uses by default. The library is built on first use from the repository's
``native/wavenet_data.cpp`` with ``g++ -O3 -fPIC -shared -std=c++17`` (the
flags of ``native/Makefile``) into the port's build directory
(``kernels._build.build_dir()``), under a name that carries a hash of the
source and the flags, written to a temporary file and renamed. Nothing is
written into ``native/``. Where no compiler or no library is at hand, every
function degrades as the JAX module's does: the codec to the numpy twins,
the others to None (the caller then uses scipy).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "wavenet_data.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def library_path() -> str:
    """The hashed library file of this source and these flags."""
    from wavenet_torch.kernels import _build
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_build.build_dir(),
                        f"libwavenet_data-{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None

        c = ctypes
        lib.wn_mulaw_encode.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_int32, c.POINTER(c.c_int32)]
        lib.wn_mulaw_decode.argtypes = [
            c.POINTER(c.c_int32), c.c_int64, c.c_int32, c.POINTER(c.c_float)]
        lib.wn_load_wav.argtypes = [
            c.c_char_p, c.POINTER(c.POINTER(c.c_float)),
            c.POINTER(c.c_int64), c.POINTER(c.c_int32)]
        lib.wn_load_wav.restype = c.c_int
        lib.wn_resample.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_int32, c.c_int32,
            c.POINTER(c.POINTER(c.c_float)), c.POINTER(c.c_int64)]
        lib.wn_resample.restype = c.c_int
        lib.wn_trim_silence.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_float, c.c_int32,
            c.POINTER(c.c_int64), c.POINTER(c.c_int64)]
        lib.wn_free.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def mu_law_encode(audio: np.ndarray, quantization_channels: int = 256
                  ) -> np.ndarray:
    lib = _load()
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    if lib is None:
        from wavenet_torch.audio import mu_law_encode_np
        return mu_law_encode_np(audio, quantization_channels)
    out = np.empty(audio.shape, dtype=np.int32)
    lib.wn_mulaw_encode(_as_float_ptr(audio), audio.size,
                        quantization_channels,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def mu_law_decode(codes: np.ndarray, quantization_channels: int = 256
                  ) -> np.ndarray:
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    if lib is None:
        from wavenet_torch.audio import mu_law_decode_np
        return mu_law_decode_np(codes, quantization_channels)
    out = np.empty(codes.shape, dtype=np.float32)
    lib.wn_mulaw_decode(codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        codes.size, quantization_channels, _as_float_ptr(out))
    return out


def _take_owned(lib, ptr, n) -> np.ndarray:
    """Copy a malloc'd C buffer into numpy and free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.wn_free(ptr)
    return arr


def load_wav(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """(mono float32 waveform, native sample rate); None -> use fallback."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    rc = lib.wn_load_wav(path.encode(), ctypes.byref(out), ctypes.byref(n),
                         ctypes.byref(sr))
    if rc != 0:
        return None
    return _take_owned(lib, out, n.value), int(sr.value)


def resample(audio: np.ndarray, sr_in: int, sr_out: int
             ) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n_out = ctypes.c_int64()
    rc = lib.wn_resample(_as_float_ptr(audio), audio.size, sr_in, sr_out,
                         ctypes.byref(out), ctypes.byref(n_out))
    if rc != 0:
        return None
    return _take_owned(lib, out, n_out.value)


def trim_silence(audio: np.ndarray, threshold: float,
                 frame_length: int = 2048) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    start = ctypes.c_int64()
    end = ctypes.c_int64()
    lib.wn_trim_silence(_as_float_ptr(audio), audio.size,
                        ctypes.c_float(threshold), frame_length,
                        ctypes.byref(start), ctypes.byref(end))
    return audio[start.value:end.value]


def read_wav(path: str, sample_rate: Optional[int] = None
             ) -> Optional[Tuple[np.ndarray, int]]:
    """Native load+resample; None -> caller should use the scipy path."""
    loaded = load_wav(path)
    if loaded is None:
        return None
    audio, native_sr = loaded
    if sample_rate is not None and sample_rate != native_sr:
        audio = resample(audio, native_sr, sample_rate)
        if audio is None:
            return None
        native_sr = sample_rate
    read_wav.calls += 1
    return audio, native_sr


#: Files decoded by the native library (read by chip_smoke.py).
read_wav.calls = 0
